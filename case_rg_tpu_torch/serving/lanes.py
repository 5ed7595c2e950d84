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
