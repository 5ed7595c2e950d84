"""Continuous-decode lane construction + pool-bucket routing
(``--pool_buckets x --continuous`` serving; port of
``case_rg_tpu/serving/lanes.py`` over the port's ``Lane`` and
``DeviceLane``)."""

from __future__ import annotations

from .featurize import bucket_for


def make_lanes(cont, bs: int, refill_size: int, wrap=None, key=None):
    """One continuous-decode Lane per pool bucket + a request router
    (``--pool_buckets x --continuous``). ``wrap`` optionally wraps each
    lane's make_batch (HTTP failure isolation); ``key(item) -> n_passages``
    adapts routing to the source's item shape (the HTTP queue wraps each
    request dict in a waiter record)."""
    from ..runtime.continuous import Lane
    lanes = {}
    for k in cont["buckets"]:
        mb = cont["make_batch_for"][k]
        lanes[k] = Lane(k, mb if wrap is None else wrap(mb), cont["init"],
                        cont["chunk"], cont["refill"], bs, refill_size,
                        refill_min=cont.get("refill_min", 1))
    getn = key or (lambda req: len(req.get("passages", [])))

    def route(item):
        return lanes[bucket_for(getn(item), cont["buckets"])]
    return list(lanes.values()), route


def make_device_lanes(cont, bs: int, refill_size: int, wrap=None, key=None):
    """One device-loop DeviceLane per pool bucket + router (``--device_loop
    x --pool_buckets``). The ``DeviceLoopFns`` is shared: it keeps one set
    of buffers, and on the card one CUDA graph, per lane shape, i.e. per
    bucket."""
    from ..runtime.continuous import DeviceLane
    fns = cont["device_fns"]
    lanes = {}
    for k in cont["buckets"]:
        mb = cont["make_batch_for"][k]
        lanes[k] = DeviceLane(k, mb if wrap is None else wrap(mb), fns,
                              bs, refill_size)
    getn = key or (lambda req: len(req.get("passages", [])))

    def route(item):
        return lanes[bucket_for(getn(item), cont["buckets"])]
    return list(lanes.values()), route


def run_lanes(source, cont, emit, max_len: int, *, ordered: bool = True,
              on_chunk=None, stream_cb=None, wrap=None, key=None,
              lane_holder=None):
    """Drive one replica's continuous loop over ``source``: the chunk loop
    or the device loop (``cont["device_fns"]``), one lane or a lane per pool
    bucket (``cont["buckets"]``), at ``cont["batch_size"]`` rows and
    ``cont["refill_size"]`` refills. ``wrap``/``key`` as ``make_lanes``';
    the lanes made are appended to ``lane_holder``. Returns the loop's
    stats."""
    bs, refill = cont["batch_size"], cont["refill_size"]
    device = cont.get("device_fns") is not None
    if "buckets" in cont:
        make = make_device_lanes if device else make_lanes
        lanes, route = make(cont, bs, refill, wrap=wrap, key=key)
        if lane_holder is not None:
            lane_holder.extend(lanes)
        if device:
            from ..runtime.continuous.device_loop import \
                run_continuous_device_multi
            return run_continuous_device_multi(
                source, lanes, route, emit, max_len, ordered=ordered,
                on_mega=on_chunk, lookahead=cont["lookahead"],
                stream_cb=stream_cb)
        from ..runtime.continuous import run_continuous_multi
        return run_continuous_multi(
            source, lanes, route, emit, ordered=ordered, on_chunk=on_chunk,
            stream_cb=stream_cb,
            async_harvest=cont.get("async_harvest", False))
    mb = cont["make_batch"] if wrap is None else wrap(cont["make_batch"])
    if device:
        from ..runtime.continuous.device_loop import run_continuous_device
        return run_continuous_device(
            source, mb, cont["device_fns"], bs, refill, emit, max_len,
            ordered=ordered, on_mega=on_chunk, lookahead=cont["lookahead"],
            stream_cb=stream_cb)
    return cont["run"](
        source, mb, cont["init"], cont["chunk"], cont["refill"], bs, refill,
        emit, ordered=ordered, on_chunk=on_chunk,
        lookahead=cont["lookahead"], refill_min=cont["refill_min"],
        async_harvest=cont.get("async_harvest", False), stream_cb=stream_cb)


def run_serving(source, cont, emit, max_len: int, *, ordered: bool = True,
                on_chunk=None, arrive=None, **kw):
    """``run_lanes`` on one device, or one ``run_lanes`` a replica over
    ``cont["replicas"]`` (each replica's own continuous dict, its share of
    the rows; ``runtime/replicas.run_continuous_replicated`` hands the
    arrivals out and restores their order). ``arrive(item)`` is called for
    each request in arrival order (replicated serving only). ``on_chunk``
    gets the chunks (or megas) of every replica together."""
    reps = cont.get("replicas")
    if not reps:
        return run_lanes(source, cont, emit, max_len, ordered=ordered,
                         on_chunk=on_chunk, **kw)
    from ..runtime.replicas import run_continuous_replicated
    counts = [0] * len(reps)

    def runner(i, c):
        def tick(n):
            counts[i] = n
            on_chunk(sum(counts))

        def run(src, em):
            return run_lanes(src, c, em, max_len, ordered=False,
                             on_chunk=None if on_chunk is None else tick,
                             **kw)
        return run
    lanes = max(len(cont.get("buckets", ())), 1)
    return run_continuous_replicated(
        source, [runner(i, c) for i, c in enumerate(reps)], emit,
        [lanes * (c["batch_size"] + c["refill_size"]) for c in reps],
        ordered=ordered, replicas=cont["replica_set"], arrive=arrive)
