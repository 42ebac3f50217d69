"""The port's examples (``examples/torch_port/``) against the reference's.

Each port example byte-compiles and names only ``repro_torch`` attributes
that exist; each runs on the CPU (``--device cpu``: the kernels' plain
versions) at small flags in a fresh interpreter. Where an example prints
figures that depend only on the key stream, they must equal the reference
example's, run on JAX on the CPU beside it: ``quickstart``'s working sets,
MEM-PS hit rate and remote bytes; ``train_lm_hierps``'s parameter counts
and row-cache hit rate; ``retrieve_ads``' index rows, corpus shape and
retrieval counters. The losses differ: the two packages draw their weights
from different generators.
"""

import ast
import importlib
import importlib.util
import os
import py_compile
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch.configs.ctr_models import TINY  # noqa: E402
from repro_torch.retrieval.index import padded_dim  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_EXAMPLES = ROOT / "examples" / "torch_port"
NAMES = ("quickstart", "retrieve_ads", "serve_lm", "train_ctr_e2e", "train_lm_hierps")
# the reference runs for the comparisons, at the port runs' flags
COMPARED = {
    "quickstart": [],
    "retrieve_ads": ["--batches", "2"],
    "train_lm_hierps": ["--steps", "3"],
}
TIMEOUT = 240


def _start(path: Path, args: list[str], **env) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, str(path), *args], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1", **env))


def _finish(proc: subprocess.Popen) -> str:
    try:
        out, err = proc.communicate(timeout=TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, \
        f"{proc.args}: rc {proc.returncode}\n{out[-2000:]}\n{err[-3000:]}"
    return out


@pytest.fixture(scope="module")
def reference():
    """The reference examples, started together (each compiles its step
    with JAX on the CPU), read when a test needs one."""
    procs = {name: _start(ROOT / "examples" / f"{name}.py", args, JAX_PLATFORMS="cpu")
             for name, args in COMPARED.items()}
    outs = {}

    def get(name):
        if name not in outs:
            outs[name] = _finish(procs[name])
        return outs[name]

    yield get
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()


def port(name: str, *args: str) -> str:
    return _finish(_start(PORT_EXAMPLES / f"{name}.py", ["--device", "cpu", *args]))


def _lines(out: str, pattern: str) -> list[str]:
    return [m.group(0) for m in re.finditer(pattern, out, flags=re.M)]


@pytest.mark.parametrize("name", NAMES)
def test_port_example_compiles_and_resolves_its_imports(name):
    path = PORT_EXAMPLES / f"{name}.py"
    py_compile.compile(str(path), doraise=True)
    imported = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module:
            top = node.module.split(".")[0]
            assert top not in ("jax", "repro"), f"{name} imports {node.module}"
            if top == "repro_torch":
                mod = importlib.import_module(node.module)
                for alias in node.names:
                    assert hasattr(mod, alias.name) or importlib.util.find_spec(
                        f"{node.module}.{alias.name}"), f"{node.module}.{alias.name}"
                imported.add(node.module)
        elif isinstance(node, ast.Import):
            assert all(a.name.split(".")[0] not in ("jax", "repro") for a in node.names)
    assert imported, f"{name} imports nothing of repro_torch"
    assert '"--device", default="cuda"' in path.read_text()


def test_quickstart_prints_the_reference_working_sets_hit_rate_and_bytes(reference):
    got = port("quickstart")
    want = reference("quickstart")
    pattern = r"working_set=\d+$|^MEM-PS hit rate: .*$"
    assert len(_lines(got, pattern)) == 11
    assert _lines(got, pattern) == _lines(want, pattern)


def test_train_lm_hierps_prints_the_reference_params_and_hit_rate(reference):
    got = port("train_lm_hierps", *COMPARED["train_lm_hierps"])
    want = reference("train_lm_hierps")
    pattern = r"^backbone params: .*$|^embedding-row cache hit rate: .*$"
    assert len(_lines(got, pattern)) == 2
    assert _lines(got, pattern) == _lines(want, pattern)
    assert re.search(r"^3 steps in \d+s; loss [\d.]+ -> [\d.]+$", got, flags=re.M), got


def test_retrieve_ads_indexes_the_reference_rows(reference):
    got = port("retrieve_ads", *COMPARED["retrieve_ads"])
    want = reference("retrieve_ads")
    index = r"^== index: (\d+) ads, corpus \((\d+), (\d+)\), version 1$"
    (g_rows, g_n, g_d), = re.findall(index, got, flags=re.M)
    (w_rows, w_n, w_d), = re.findall(index, want, flags=re.M)
    # the reference pads its corpus to TPU lanes; the port pads no rows and
    # the features only to a multiple of 4 (retrieval/index.py)
    assert g_rows == w_rows and int(w_n) >= int(w_rows) and int(w_d) >= TINY.emb_dim
    assert (int(g_n), int(g_d)) == (int(w_rows), padded_dim(TINY.emb_dim))
    counters = r"^   retrieval_\w+: \d+$|^== rolled 1 -> 2; .*|^== published snapshot version \d+$"
    assert _lines(got, counters)[0] == _lines(want, counters)[0]
    assert [ln for ln in _lines(got, counters) if "rolled" not in ln] == \
        [ln for ln in _lines(want, counters) if "rolled" not in ln]
    assert len(re.findall(r"^   user \d: ", got, flags=re.M)) == 8


def test_serve_lm_runs_on_cpu():
    got = port("serve_lm", "--batch", "2", "--prompt-len", "16", "--new-tokens", "4",
               "--wire-quantize")
    assert "serving snapshot v1 (publish = manifest repoint, no copy)" in got
    assert re.search(r"^prefill: 2x16 tokens in \d+ ms$", got, flags=re.M), got
    assert re.search(r"^hot-row cache hit rate: [\d.]+% over 5 lookups$", got, flags=re.M), got
    assert re.search(r"^wire-quantized replies: \d+ ", got, flags=re.M), got
    sampled = re.search(r"^sampled: \[([\d ]+)\] \.\.\.$", got, flags=re.M)
    assert sampled and len(sampled.group(1).split()) == 4


@pytest.mark.parametrize("feed", ["ingest", "host_feeder"])
def test_train_ctr_e2e_runs_on_cpu(feed):
    extra = ["--host-feeder"] if feed == "host_feeder" else ["--wire-quantize-train"]
    got = port("train_ctr_e2e", "--batches", "3", "--keys", "20000", "--nodes", "2", *extra)
    after = re.search(r"^AUC after training: ([\d.]+) ", got, flags=re.M)
    assert after and 0.0 <= float(after.group(1)) <= 1.0, got
    assert re.search(r"^trained 3 batches in ", got, flags=re.M), got
    if feed == "ingest":
        assert "ingest: 3 batches staged" in got and "wire push: " in got, got
    else:
        assert "feed: host feeder (numpy extraction)" in got and "ingest:" not in got


HELD = ("embedding_bag", "scatter_add", "fused_adagrad", "feature_extract", "topk_mips",
        "embedding_lookup", "flash_attention", "flash_attention_backward")


def _held_launches(wrong: str | None) -> dict:
    """``chip_smoke.held_kernels`` over a stand-in of ``kernels.ops`` whose
    kernel wrappers are the plain versions, ``wrong``'s perturbed (the flash
    backward's by 2%, past its 1e-2 tolerance), each called once on seeded
    CPU inputs at small shapes -> the holds' record."""
    import types

    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    from repro_torch.kernels.embedding_bag import embedding_bag_plain
    from repro_torch.kernels.embedding_lookup import embedding_lookup_plain
    from repro_torch.kernels.feature_extract import feature_extract_plain
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_plain,
        flash_attention_plain,
    )
    from repro_torch.kernels.fused_adagrad import adagrad_plain
    from repro_torch.kernels.scatter_add import scatter_add_plain_
    from repro_torch.kernels.topk_mips import topk_mips_plain

    def kernel(name, plain):
        if name != wrong:
            return plain

        def off(*args, **kw):
            out = plain(*args, **kw)
            if name == "topk_mips":  # right scores, the next row's ids
                return out[0], torch.where(out[1] >= 0, (out[1] + 1) % args[1].shape[0], -1)
            if name == "feature_extract":
                return out[0] + 1, out[1]
            if name == "flash_attention_backward":
                return tuple(t * 1.02 for t in out)
            if isinstance(out, tuple):
                return out[0] * (1 + 2**-10), out[1]
            return out * (1 + 2**-10)
        return off

    ops = types.SimpleNamespace(
        embedding_bag_cuda=kernel("embedding_bag", embedding_bag_plain),
        scatter_add_cuda_=kernel("scatter_add", scatter_add_plain_),
        adagrad_cuda=kernel("fused_adagrad", adagrad_plain),
        feature_extract_cuda=kernel("feature_extract", feature_extract_plain),
        topk_mips_cuda=kernel("topk_mips", topk_mips_plain),
        embedding_lookup_cuda=kernel("embedding_lookup", embedding_lookup_plain),
        flash_attention_cuda=kernel("flash_attention", flash_attention_plain),
        flash_attention_bwd_cuda=kernel("flash_attention_backward", flash_attention_bwd_plain))
    wrappers, record = chip_smoke.held_kernels(ops)
    g = torch.Generator().manual_seed(0)
    table = torch.randn(50, 4, generator=g)
    ids = torch.randint(0, 50, (6, 10), generator=g, dtype=torch.int32)
    slot_of = torch.randint(0, 3, (6, 10), generator=g, dtype=torch.int32)
    valid = torch.rand(6, 10, generator=g) > 0.2
    wrappers["embedding_bag_cuda"](table, ids, slot_of, valid, 3)
    wrappers["scatter_add_cuda_"](table.clone(), ids.reshape(-1).sort().values,
                                  torch.randn(60, 4, generator=g))
    wrappers["adagrad_cuda"](table, table.abs(), torch.randn(50, 4, generator=g), 0.05, 1e-8)
    raw = torch.randint(-2**62, 2**62, (6, 10), generator=g)
    wrappers["feature_extract_cuda"](raw, valid, n_keys=1000, n_slots=25, key_seed=17,
                                     slot_seed=31)
    wrappers["topk_mips_cuda"](torch.randn(3, 4, generator=g), table, 5, n_valid=40)
    wrappers["embedding_lookup_cuda"](table, ids[0])
    q = torch.randn(1, 2, 8, 16, generator=g)
    wrappers["flash_attention_cuda"](q, q, q, causal=True, window=0, q_offset=0, group=1,
                                     head_offset=0)
    o, lse = flash_attention_plain(q, q, q, return_lse=True)
    wrappers["flash_attention_bwd_cuda"](q, q, q, o, lse, torch.randn(1, 2, 8, 16, generator=g),
                                         causal=True, window=0, q_offset=0, group=1,
                                         head_offset=0)
    return record


@pytest.mark.parametrize("wrong", (None, *HELD))
def test_examples_phase_holds_each_kernel_launch_against_its_plain_version(wrong):
    """The card's ``examples`` phase holds every kernel launch in an example
    against the plain version: the plain versions pass, and a kernel off by
    one part in 1,024, or returning the wrong rows, fails."""
    record = _held_launches(wrong)
    assert {k: r["held"] for k, r in record.items()} == dict.fromkeys(HELD, 1)
    assert {k for k, r in record.items() if r["failed"]} == ({wrong} if wrong else set())
