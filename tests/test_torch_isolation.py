"""The port stands alone, and its copies of the reference stay copies.

* No module under ``src/repro_torch/`` and not ``chip_smoke.py`` imports
  ``jax`` or anything of ``repro`` (an AST scan of every import).
* Running the serving slice, the training slice, the ingestion slice or the
  LM serving slice on the CPU in a fresh interpreter loads neither ``jax``
  nor any ``repro`` module.
* Drift guard: each module the port copies from the reference equals its
  original with ``repro.`` -> ``repro_torch.``, except the listed lines; the
  partial copies (single functions and classes) equal theirs the same way.
"""

import ast
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
REF = ROOT / "src" / "repro"

# modules copied whole; the value lists the reference lines the port drops
COPIES = {
    "core/keys.py": (),
    "core/hash_index.py": (),
    "core/tables.py": (),
    "core/ssd_ps.py": (),
    "core/compression.py": (),
    "core/recovery.py": (),
    "core/mem_ps.py": (),
    "core/pipeline.py": (),
    "core/hier_ps.py": (),
    "core/client.py": (),
    "core/faults.py": (),
    "core/hashing.py": (),
    "core/elastic.py": (),
    # the SanLock registration: port lock analysis is not wired up yet
    "core/node.py": (
        "        # the SanLock sanitizer (REPRO_SANLOCK=1) asserts total_pins()==0 at",
        "        # test teardown for every cluster; registration is a weakref append",
        "        from repro.analysis import sanlock",
        "        sanlock.register_cluster(self)",
    ),
    "metrics.py": (),
    "serve/snapshot.py": (),
    "configs/ctr_models.py": (),
    "configs/__init__.py": (),
    "configs/granite_20b.py": (),
    "configs/hymba_1p5b.py": (),
    "configs/nemotron_4_340b.py": (),
    "configs/olmoe_1b_7b.py": (),
    "configs/phi35_moe.py": (),
    "configs/phi3_mini_3p8b.py": (),
    "configs/pixtral_12b.py": (),
    "configs/whisper_tiny.py": (),
    "configs/xlstm_1p3b.py": (),
    "configs/yi_9b.py": (),
    "data/synthetic_ctr.py": (),
    "data/tokens.py": (),
}
# functions and classes copied into modules the port otherwise rewrites
PARTIAL_COPIES = {
    "train/checkpoint.py": ("atomic_write_json", "flip_pointer", "_jsonify", "_flatten",
                            "_unflatten_into", "save", "latest_step", "restore_extra_arrays",
                            "restore"),
    "core/hbm_ps.py": ("HotPlan", "HotSetStats", "ReusePlan", "ReuseStats"),
    "serve/engine.py": ("HotRowCache", "LiveClusterView", "_Request"),
    "retrieval/engine.py": ("RetrievalResult",),
}


def _port_text(src: str) -> str:
    return src.replace("repro.", "repro_torch.")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_port_and_chip_smoke_import_neither_jax_nor_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = [f"{p.relative_to(ROOT)}:{line} imports {name}"
           for p in files for line, name in _imports(p) if _forbidden(name)]
    assert not bad, bad


def test_serving_slice_runs_without_loading_jax_or_repro(tmp_path):
    script = textwrap.dedent(f"""
        import json, sys
        import numpy as np
        from repro_torch.configs.ctr_models import CTRConfig, table_specs
        from repro_torch.convert import publish_arrays
        from repro_torch.data.synthetic_ctr import SyntheticCTRStream
        from repro_torch.retrieval import RetrievalEngine
        from repro_torch.serve import ServingCluster, ServingEngine

        cfg = CTRConfig("ctr-small", 2000, 16, 8, 4, (8,), 8, 1)
        spec = table_specs(cfg)[0]
        rows = (np.random.default_rng(0).integers(-8, 8, (2000, 16)) / 16).astype(np.float32)
        publish_arrays({str(tmp_path)!r}, n_nodes=2, dim=16, init_cols=8,
                       tables={{spec.name: (spec, np.arange(2000, dtype=np.uint64), rows)}})
        eng = ServingEngine(ServingCluster({str(tmp_path)!r}), device_hot_rows=64, device="cpu")
        retr = RetrievalEngine(eng, spec.name, device="cpu")
        b = SyntheticCTRStream(2000, 16, 4, 8, seed=1).next_batch()
        q = np.einsum("bn,bnd->bd", b.valid.astype(np.float32), eng.lookup(spec.name, b.keys))
        res = retr.search(q, 10)
        retr.rerank(res, b.keys, b.slot_of, b.valid, n_slots=4)
        eng.lookup_device(spec.name, b.keys[:2])
        eng.lookup_device(spec.name, b.keys[:2])
        print(json.dumps(sorted(m for m in sys.modules
                                if m.split(".")[0] in ("jax", "jaxlib", "repro"))))
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         env=env, timeout=240, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_training_slice_runs_without_loading_jax_or_repro(tmp_path):
    script = textwrap.dedent(f"""
        import json, sys
        from repro_torch.configs.ctr_models import TINY
        from repro_torch.core.node import Cluster
        from repro_torch.data.synthetic_ctr import SyntheticCTRStream
        from repro_torch.train.trainer import CTRTrainer, TrainerConfig

        cl = Cluster(2, {str(tmp_path / "ps")!r}, dim=2 * TINY.emb_dim, cache_capacity=2048,
                     file_capacity=128, init_cols=TINY.emb_dim)
        tcfg = TrainerConfig(checkpoint_every=2, checkpoint_dir={str(tmp_path / "ck")!r})
        tr = CTRTrainer(TINY, cl, tcfg, device="cpu")
        stream = SyntheticCTRStream(TINY.n_sparse_keys, TINY.nnz_per_example, TINY.n_slots,
                                    TINY.batch_size, seed=1)
        res = tr.run(stream, 2)
        assert len(res) == 2 and tr.resume() == 2
        print(json.dumps(sorted(m for m in sys.modules
                                if m.split(".")[0] in ("jax", "jaxlib", "repro"))))
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         env=env, timeout=240, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_ingest_slice_runs_without_loading_jax_or_repro(tmp_path):
    script = textwrap.dedent(f"""
        import json, sys
        import repro_torch.ingest
        from repro_torch.configs.ctr_models import TINY
        from repro_torch.core.node import Cluster
        from repro_torch.data.synthetic_ctr import SyntheticCTRStream
        from repro_torch.train.trainer import CTRTrainer, TrainerConfig

        cl = Cluster(2, {str(tmp_path / "ps")!r}, dim=2 * TINY.emb_dim, cache_capacity=2048,
                     file_capacity=128, init_cols=TINY.emb_dim)
        tr = CTRTrainer(TINY, cl, TrainerConfig(ingest=True), device="cpu")
        stream = SyntheticCTRStream(TINY.n_sparse_keys, TINY.nnz_per_example, TINY.n_slots,
                                    TINY.batch_size, seed=1)
        res = tr.run(stream.raw_records(), 3)
        assert len(res) == 3 and tr.ingestor.counters["ingest_batches"] == 3
        assert tr.ingestor.ring.live_slots == 0
        print(json.dumps(sorted(m for m in sys.modules
                                if m.split(".")[0] in ("jax", "jaxlib", "repro"))))
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         env=env, timeout=240, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_lm_serving_slice_runs_without_loading_jax_or_repro(tmp_path):
    script = textwrap.dedent(f"""
        import json, sys
        import numpy as np
        import torch
        from repro_torch.configs import get_smoke_config
        from repro_torch.convert import publish_arrays
        from repro_torch.core.tables import RowSchema, TableSpec
        from repro_torch.data.tokens import TokenStream
        from repro_torch.models import transformer as T
        from repro_torch.models.attention import KVCache
        from repro_torch.serve import ServingCluster, ServingEngine
        from repro_torch.serve.serve_step import greedy_sample, make_decode_step, make_prefill_step

        cfg = get_smoke_config("yi-9b")
        V, d = cfg.vocab_size, cfg.d_model
        spec = TableSpec("tok_emb", RowSchema.embedding(d))
        rows = np.random.default_rng(0).standard_normal((V, d), dtype=np.float32)
        publish_arrays({str(tmp_path)!r}, n_nodes=2, dim=d,
                       tables={{"tok_emb": (spec, np.arange(V, dtype=np.uint64), rows)}})
        eng = ServingEngine(ServingCluster({str(tmp_path)!r}), device_hot_rows=64, device="cpu")
        params = T.init(cfg, torch.Generator().manual_seed(0), dtype=torch.bfloat16)
        prompts = TokenStream(V, 2, 16, seed=1).next_batch()[:, :16].astype(np.uint64)
        slots, wt = eng.lookup_device("tok_emb", prompts)
        logits, cache = make_prefill_step(cfg)(params, {{"tokens": torch.from_numpy(slots),
                                                         "working_table": wt}})
        cache = KVCache(*(torch.nn.functional.pad(a, (0, 0, 0, 2)) for a in cache))
        decode = make_decode_step(cfg)
        for i in range(2):
            tok = greedy_sample(logits).numpy().astype(np.uint64)
            slots, wt = eng.lookup_device("tok_emb", tok)
            logits, cache = decode(params, {{"token": torch.from_numpy(slots),
                                             "working_table": wt}}, cache, 16 + i)
        assert logits.shape == (2, 1, V) and bool(torch.isfinite(logits).all())
        print(json.dumps(sorted(m for m in sys.modules
                                if m.split(".")[0] in ("jax", "jaxlib", "repro"))))
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         env=env, timeout=240, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("rel", sorted(COPIES))
def test_copied_module_matches_reference(rel):
    want = _port_text((REF / rel).read_text()).splitlines()
    dropped = {_port_text(line) for line in COPIES[rel]}
    assert len(dropped) == sum(line in dropped for line in want), "allowed lines must exist"
    got = (PORT / rel).read_text().splitlines()
    assert got == [line for line in want if line not in dropped]


def _definitions(path: Path, names) -> dict[str, str]:
    src = path.read_text()
    tree = ast.parse(src)
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and node.name in names:
            out.setdefault(node.name, ast.get_source_segment(src, node))
    return out


@pytest.mark.parametrize("rel", sorted(PARTIAL_COPIES))
def test_partially_copied_module_keeps_reference_definitions(rel):
    names = PARTIAL_COPIES[rel]
    got = _definitions(PORT / rel, names)
    want = _definitions(REF / rel, names)
    assert sorted(got) == sorted(want) == sorted(names)
    for name in names:
        assert got[name] == _port_text(want[name]), name
