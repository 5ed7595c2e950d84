"""The port's testing and serving entry points with the passage pool split
over a device group (``cli/run --mode test --pool_shard --mesh_shape D,M``,
``cli/serve --pool_shard N``), on the CPU with ``--device cpu,cpu`` (one
group of two) and four CPU devices (two groups of two), against the same
entry point unsplit on one device.

The module fixture is ``tests/test_torch_replicas_cli.py``'s: the toy
corpus prepared by the port's ``cli/prepare`` (a pool of 4), CaSE trained
two epochs by the port's ``cli/run`` (f32, B=4), and 16 serving requests,
so the groups take each epoch's new weights. Held here:

* ``cli/run --mode test`` over groups writes the unsplit result files:
  ``.answer`` byte for byte, ``.run`` the same rankings with each score
  within 1e-5 (``tests/test_torch_run._same_results``: two groups take
  two rows each, whose GEMMs may round otherwise than over the batch's
  four); batched (``trainer.predict``), the chunk loop and the device
  loop;
* ``cli/serve --pool_shard 2`` writes the unsplit JSONL (``tests/
  test_torch_serve._same_responses``: the same answers, rankings equal but
  for the order of scores within 1e-5 of each other): batched with batch
  and pool buckets, the continuous chunk loop with lookahead, the device
  loop with pool buckets, and the HTTP server's continuous loop;
* each CLI refuses, with a message, a group size that does not divide
  the devices or a served pool, ``--pool_shard`` without a model axis
  above 1 and a model axis without ``--pool_shard`` at test time, and
  ``--pool_shard`` outside ``--mode test``.
"""

import json
import os

import pytest

from case_rg_tpu_torch.cli.run import main as run_main
from case_rg_tpu_torch.cli.serve import main as serve_main
from tests.test_torch_kernels import one_torch_thread  # noqa: F401
from tests.test_torch_replicas_cli import (  # noqa: F401
    _serve, _test_run, trained)
from tests.test_torch_run import _same_results, _stems
from tests.test_torch_serve import _http, _same_responses

POOL = ["--pool_shard", "--mesh_shape", "1,2"]


@pytest.mark.parametrize("device, extra", [
    ("cpu,cpu,cpu,cpu", []),
    ("cpu,cpu", ["--continuous", "--refill", "2", "--chunk_steps", "3"]),
    ("cpu,cpu", ["--continuous", "--refill", "2", "--device_loop", "2",
                 "--chunk_steps", "2"])],
    ids=["batched", "chunk-loop", "device-loop"])
def test_cli_test_pool_split_writes_the_unsplit_files(trained, device,
                                                      extra):
    tag = "-".join(extra).replace("--", "") or "batched"
    want = _test_run(trained, f"unsplit-{tag}", "cpu", extra)
    got = _test_run(trained, f"pool-{tag}", device, POOL + extra)
    with open(os.path.join(want, "toy_test_1.0.answer")) as f:
        assert f.read().strip()
    _same_results(os.path.dirname(got), os.path.dirname(want),
                  _stems([0, 1]))


@pytest.mark.parametrize("extra", [
    ["--batch_buckets", "2,4", "--pool_buckets", "2,4"],
    ["--continuous", "--refill", "2", "--chunk_steps", "3", "--lookahead"],
    ["--continuous", "--refill", "2", "--device_loop", "2", "--chunk_steps",
     "2", "--pool_buckets", "2,4", "--warmup"]],
    ids=["batched", "chunk-loop", "device-loop"])
def test_cli_serve_pool_split_equals_unsplit(trained, extra, capsys):
    """One group of two (``--device cpu,cpu``) answers every request as
    one device does, in request order."""
    name = "pool-" + "-".join(extra).replace("--", "")
    want = _serve(trained, name, "cpu", extra)
    assert "pool split" not in capsys.readouterr().err
    got = _serve(trained, name, "cpu,cpu", ["--pool_shard", "2"] + extra)
    assert ", pool split 2 ways)" in capsys.readouterr().err
    assert len(want.splitlines()) == len(trained["reqs"])
    _same_responses([json.loads(x) for x in got.splitlines()],
                    [json.loads(x) for x in want.splitlines()],
                    trained["scores"]["bucketed" if "--pool_buckets" in extra
                                      else "padded"])


def test_http_pool_split_over_two_groups(trained):
    """The HTTP server's continuous loop over two groups of two (four CPU
    devices) answers each request as the unsplit offline run does."""
    extra = ["--continuous", "--refill", "2", "--chunk_steps", "2"]
    want = {json.loads(x)["id"]: json.loads(x) for x in
            _serve(trained, "pool-http-ref", "cpu", extra).splitlines()}
    reqs = [r for r in trained["reqs"] if "id" in r]
    got, varz, _ = _http(None, extra + ["--device", "cpu,cpu,cpu,cpu",
                                        "--pool_shard", "2"],
                         [reqs[i::3] for i in range(3)],
                         common=trained["serve"])
    assert varz["errors"] == 0 and varz["requests_served"] == len(reqs)
    _same_responses([got[r["id"]] for r in reqs],
                    [want[r["id"]] for r in reqs],
                    trained["scores"]["padded"])


REFUSED = [
    ("serve", ["--pool_shard", "3", "--device", "cpu,cpu,cpu"],
     r"--pool_shard 3 must divide every served pool size; offending: \[4\]"),
    ("serve", ["--pool_shard", "2", "--pool_buckets", "3,4", "--device",
               "cpu,cpu"], r"offending: \[3\]"),
    ("serve", ["--pool_shard", "2", "--device", "cpu"],
     "model axis 2 does not divide the 1 local devices"),
    ("run", ["--pool_shard", "--device", "cpu,cpu"],
     "--pool_shard needs --mesh_shape with model>1"),
    ("run", ["--mesh_shape", "1,2", "--device", "cpu,cpu"],
     "add --pool_shard"),
    ("run", POOL + ["--device", "cpu,cpu,cpu"],
     "model axis 2 does not divide the 3 local devices"),
    ("run", ["--pool_shard", "--mesh_shape", "1,3", "--device",
             "cpu,cpu,cpu"],
     r"'passage' pool axis \(4\) is not divisible by the 'model' mesh "
     r"axis \(3\)"),
    ("run", POOL + ["--mode", "avg"], "applies to --mode test")]


def test_what_does_not_split_is_refused(trained, tmp_path):
    """Each case exits with its message before a checkpoint is read."""
    for cli, extra, message in REFUSED:
        if cli == "serve":
            argv = trained["serve"] + ["--output", str(tmp_path / "o.jsonl")]
            main = serve_main
        else:
            argv = trained["common"] + ["--output_path", str(tmp_path),
                                        "--mode", "test", "--epoch", "2"]
            main = run_main
        with pytest.raises(SystemExit, match=message):
            main(argv + extra)
