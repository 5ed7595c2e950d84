"""``cli/serve --from_export`` against the JAX package's CLI, the export's
sidecar, and the refused archives (moved from ``tests/test_torch_serve.py``,
whose module fixture and docstring they share)."""

import json
import os

import pytest

from case_rg_tpu_torch.cli.serve import main as port_main
from tests.test_torch_export import shared_export_loads  # noqa: F401
from tests.test_torch_kernels import one_torch_thread  # noqa: F401
from tests.test_torch_serve import (  # noqa: F401
    SHAPES, SIDECAR_KEYS, _http, _same_jsonl, _same_responses,
    saved_programs_served, served)


@pytest.fixture(scope="module")
def exported(served):
    """The port's cli/export_model on the CPU from the JAX checkpoint, at
    the JAX CLI's batch size; the requests file and the serving arguments
    of the archive."""
    from case_rg_tpu_torch.cli.export_model import main as export_main
    art = os.path.join(served["root"], "case_b4.pt2")
    common = served["common"]
    report = export_main(["--model", "case", "--prepared_dir", served["prep"],
                          "--output_path", served["out"], "--out", art,
                          "--batch_size", "4", "--device", "cpu"] + SHAPES)
    req = common[common.index("--input") + 1]
    return {"art": art, "report": report,
            "common": ["--prepared_dir", served["prep"], "--from_export",
                       art, "--input", req]}


def test_export_sidecar(served, exported):
    """The sidecar has the JAX CLI's keys, the CPU as its platform, and
    ``chunk_to_batch``'s input shapes and dtypes."""
    from case_rg_tpu_torch.config import DataConfig
    from case_rg_tpu_torch.data.vocab import Vocabulary
    from case_rg_tpu_torch.serving.featurize import chunk_to_batch
    with open(exported["art"] + ".json") as f:
        side = json.load(f)
    assert set(side) == SIDECAR_KEYS and side == exported["report"]["sidecar"]
    assert side["platforms"] == ["cpu"] and side["batch_size"] == 4
    assert side["data"] == {"query_len": 24, "passage_len": 24,
                            "num_passage": 4}
    vocab = Vocabulary.load(os.path.join(served["prep"], "vocab.txt"))
    batch = chunk_to_batch(served["reqs"][:1], "case", vocab, DataConfig(
        query_len=24, passage_len=24, num_passage=4, answer_len=10), 4)
    assert side["inputs"] == {k: {"shape": list(v.shape),
                                  "dtype": str(v.dtype)}
                              for k, v in batch.items()}


def test_from_export_equals_the_jax_package(served, exported):
    """cli/serve --from_export on the CPU writes the JAX CLI's JSONL."""
    path = os.path.join(served["root"], "from_export.jsonl")
    port_main(exported["common"] + ["--output", path, "--device", "cpu"])
    with open(path) as f:
        _same_jsonl(f.read(), served)


def test_from_export_early_exit_equals_the_jax_package(served):
    """The JAX checkpoint exported with ``--early_exit`` (the decode a
    ``while_loop``) and served with cli/serve --from_export on the CPU
    writes the JAX CLI's JSONL; its sidecar has the JAX CLI's keys."""
    from case_rg_tpu_torch.cli.export_model import main as export_main
    art = os.path.join(served["root"], "case_b4_early.pt2")
    report = export_main(["--model", "case", "--prepared_dir",
                          served["prep"], "--output_path", served["out"],
                          "--out", art, "--batch_size", "4", "--early_exit",
                          "--device", "cpu"] + SHAPES)
    assert set(report["sidecar"]) == SIDECAR_KEYS
    common = served["common"]
    path = os.path.join(served["root"], "from_export_early.jsonl")
    port_main(["--prepared_dir", served["prep"], "--from_export", art,
               "--input", common[common.index("--input") + 1], "--output",
               path, "--device", "cpu"])
    with open(path) as f:
        _same_jsonl(f.read(), served)


def test_from_export_over_http(served, exported):
    """The --listen front end serves the archive as the batched one does."""
    reqs = served["reqs"][:-1]
    got, varz, _ = _http(served, [], [reqs[i::3] for i in range(3)],
                         common=exported["common"])
    want = [json.loads(x) for x in served["want"].splitlines()][:-1]
    _same_responses([got[w["id"]] for w in want], want, served["scores"])
    assert varz["errors"] == 0 and varz["requests_served"] == len(reqs)


@pytest.mark.parametrize("case", ["platform", "not_an_archive",
                                  "no_sidecar"])
def test_from_export_refusals(served, exported, tmp_path, case):
    """An archive traced for the card served with --device cpu, a file
    that is not a torch.export archive (a JAX .shlo with a ["cpu"]
    sidecar), and an archive without its sidecar are refused."""
    with open(exported["art"] + ".json") as f:
        side = json.load(f)
    art = str(tmp_path / "case.pt2")
    if case == "platform":
        os.symlink(exported["art"], art)
        side["platforms"] = ["cuda"]
        message = r"exported for platform\(s\) \['cuda'\]"
    elif case == "not_an_archive":
        art = str(tmp_path / "case.shlo")
        with open(art, "wb") as f:
            f.write(b"ML\xefR\x0dStableHLO_v1.0.0\x00")
        message = "case.shlo is not a torch.export archive"
    else:
        os.symlink(exported["art"], art)
        side = None
        message = "cannot read sidecar"
    if side is not None:
        with open(art + ".json", "w") as f:
            json.dump(side, f)
    argv = exported["common"][:]
    argv[argv.index("--from_export") + 1] = art
    with pytest.raises(SystemExit, match=message):
        port_main(argv + ["--output", str(tmp_path / "o.jsonl"),
                          "--device", "cpu"])
