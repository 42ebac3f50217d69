"""The port stands alone, and its copies of the reference stay copies.

* No module under ``src/repro_torch/`` and not ``chip_smoke.py`` imports
  ``jax`` or anything of ``repro`` (an AST scan of every import).
* Running the serving slice, the training slice, the ingestion slice, the
  LM serving slice (dense, MoE and VLM; hybrid, SSM and audio), the LM
  training slice, the launcher and sharded working table, tensor
  parallelism on two gloo ranks, or the dry run and its report and triage
  on the CPU in a fresh interpreter loads neither ``jax`` nor any ``repro``
  module.
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
    "core/hbm_ps.py": ("HotPlan", "HotSetStats", "ReusePlan", "ReuseStats", "shard_layout",
                       "to_sharded_rows", "from_sharded_rows", "plan_a2a"),
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
    """The dense, MoE and VLM LM serving paths, at smoke widths."""
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

        for arch in ("yi-9b", "olmoe-1b-7b", "pixtral-12b"):
            cfg = get_smoke_config(arch)
            V, d = cfg.vocab_size, cfg.d_model
            spec = TableSpec("tok_emb", RowSchema.embedding(d))
            rows = np.random.default_rng(0).standard_normal((V, d), dtype=np.float32)
            snap = {str(tmp_path)!r} + "/" + arch
            publish_arrays(snap, n_nodes=2, dim=d,
                           tables={{"tok_emb": (spec, np.arange(V, dtype=np.uint64), rows)}})
            eng = ServingEngine(ServingCluster(snap), device_hot_rows=64, device="cpu")
            params = T.init(cfg, torch.Generator().manual_seed(0), dtype=torch.bfloat16)
            prompts = TokenStream(V, 2, 16, seed=1).next_batch()[:, :16].astype(np.uint64)
            slots, wt = eng.lookup_device("tok_emb", prompts)
            batch = {{"tokens": torch.from_numpy(slots), "working_table": wt}}
            if cfg.family == "vlm":
                batch["image_embeds"] = torch.randn(2, cfg.n_image_tokens, d)
            logits, cache = make_prefill_step(cfg)(params, batch)
            cache = KVCache(*(torch.nn.functional.pad(a, (0, 0, 0, 2)) for a in cache))
            decode = make_decode_step(cfg)
            pos = cache.k.shape[3] - 2
            for i in range(2):
                tok = greedy_sample(logits).numpy().astype(np.uint64)
                slots, wt = eng.lookup_device("tok_emb", tok)
                logits, cache = decode(params, {{"token": torch.from_numpy(slots),
                                                 "working_table": wt}}, cache, pos + i)
            assert logits.shape == (2, 1, V) and bool(torch.isfinite(logits).all())
        print(json.dumps(sorted(m for m in sys.modules
                                if m.split(".")[0] in ("jax", "jaxlib", "repro"))))
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         env=env, timeout=240, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_hybrid_ssm_audio_serving_runs_without_loading_jax_or_repro(tmp_path):
    """The hybrid (hymba), SSM (xlstm) and audio (whisper) serving paths, at
    smoke widths, in hier_ps mode: lookup_device -> prefill -> 2 greedy
    decode steps on each family's cache."""
    script = textwrap.dedent(f"""
        import json, sys
        import numpy as np
        import torch
        from repro_torch.configs import get_smoke_config
        from repro_torch.convert import publish_arrays
        from repro_torch.core.tables import RowSchema, TableSpec
        from repro_torch.data.tokens import TokenStream
        from repro_torch.models import get_model
        from repro_torch.serve import ServingCluster, ServingEngine
        from repro_torch.serve.serve_step import (
            greedy_sample, grow_cache, make_decode_step, make_prefill_step)

        for arch in ("hymba-1.5b", "xlstm-1.3b", "whisper-tiny"):
            cfg = get_smoke_config(arch)
            V, d = cfg.vocab_size, cfg.d_model
            spec = TableSpec("tok_emb", RowSchema.embedding(d))
            rows = np.random.default_rng(0).standard_normal((V, d), dtype=np.float32)
            snap = {str(tmp_path)!r} + "/" + arch
            publish_arrays(snap, n_nodes=2, dim=d,
                           tables={{"tok_emb": (spec, np.arange(V, dtype=np.uint64), rows)}})
            eng = ServingEngine(ServingCluster(snap), device_hot_rows=64, device="cpu")
            model = get_model(cfg)
            params = model.init(cfg, torch.Generator().manual_seed(0), dtype=torch.bfloat16)
            prompts = TokenStream(V, 2, 40, seed=1).next_batch()[:, :40].astype(np.uint64)
            slots, wt = eng.lookup_device("tok_emb", prompts)
            batch = {{"tokens": torch.from_numpy(slots), "working_table": wt}}
            if cfg.family == "audio":
                batch["frames"] = torch.randn(2, cfg.n_frames, d)
            logits, cache = make_prefill_step(cfg)(params, batch)
            pos = 40 + cfg.n_meta_tokens
            assert (cache is None) == (cfg.family == "ssm")
            cache = grow_cache(cfg, cache, 2, batch=2, device="cpu")
            decode = make_decode_step(cfg)
            for i in range(2):
                tok = greedy_sample(logits).numpy().astype(np.uint64)
                slots, wt = eng.lookup_device("tok_emb", tok)
                logits, cache = decode(params, {{"token": torch.from_numpy(slots),
                                                 "working_table": wt}}, cache, pos + i)
            assert logits.shape == (2, 1, V) and bool(torch.isfinite(logits).all())
        print(json.dumps(sorted(m for m in sys.modules
                                if m.split(".")[0] in ("jax", "jaxlib", "repro"))))
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         env=env, timeout=240, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_lm_training_slice_runs_without_loading_jax_or_repro(tmp_path):
    """The LM training slice at smoke widths: the hier_ps step through
    ``PSClient`` sessions of a ``tok_emb`` table (yi-9b, olmoe-1b-7b), and the
    dense step with the audio family's frames (whisper-tiny), the optimizers
    and the nested AdamW state conversion."""
    script = textwrap.dedent(f"""
        import json, sys
        import numpy as np
        import torch
        from repro_torch.configs import get_smoke_config
        from repro_torch.convert import lm_adam_state_from_numpy
        from repro_torch.core.client import PSClient
        from repro_torch.core.node import Cluster
        from repro_torch.core.tables import RowSchema, TableSpec
        from repro_torch.data.tokens import TokenStream
        from repro_torch.models import get_model
        from repro_torch.train.optim import AdamW, Adagrad, cosine_schedule, tree_map
        from repro_torch.train.train_step import (
            TrainSettings, make_lm_train_step, make_lm_train_step_hier)

        settings = TrainSettings(optimizer=AdamW(lr=1e-3), microbatches=2)
        for arch in ("yi-9b", "olmoe-1b-7b"):
            cfg = get_smoke_config(arch)
            params = get_model(cfg).init(cfg, torch.Generator().manual_seed(0))
            opt = settings.optimizer.init(params)
            cl = Cluster(2, {str(tmp_path)!r} + "/" + arch, dim=2 * cfg.d_model,
                         cache_capacity=512, file_capacity=64, init_scale=0.02)
            client = PSClient(cl, [TableSpec("tok_emb", RowSchema.with_adagrad(cfg.d_model))])
            step = make_lm_train_step_hier(cfg, settings)
            stream = TokenStream(cfg.vocab_size, 4, 17, seed=1)
            for _ in range(2):
                toks = stream.next_batch()
                with client.session("tok_emb", toks[:, :-1].astype(np.uint64)) as s:
                    batch = {{"tokens": torch.from_numpy(s.slots),
                              "targets": torch.from_numpy(toks[:, 1:].astype(np.int64))}}
                    params, opt, m, t, a = step(params, opt, batch, torch.from_numpy(s.params),
                                                torch.from_numpy(s.opt_state))
                    s.commit(t.numpy(), a.numpy())
                assert np.isfinite(float(m["loss"]))
        cfg = get_smoke_config("whisper-tiny")
        import dataclasses
        cfg = dataclasses.replace(cfg, embedding_mode="dense")
        params = get_model(cfg).init(cfg, torch.Generator().manual_seed(0))
        batch = {{"tokens": torch.randint(0, cfg.vocab_size, (4, 8)),
                  "targets": torch.randint(0, cfg.vocab_size, (4, 8)),
                  "frames": torch.randn(4, cfg.n_frames, cfg.d_model)}}
        opt = settings.optimizer.init(params)
        params, opt, m = make_lm_train_step(cfg, settings)(params, opt, batch)
        assert np.isfinite(float(m["loss"]))
        state = lm_adam_state_from_numpy(
            (1, tree_map(lambda t: t.numpy(), opt.m), tree_map(lambda t: t.numpy(), opt.v)),
            device="cpu")
        Adagrad().update(params, Adagrad().init(params), params)
        assert float(cosine_schedule(1.0, 2, 10)(1)) == 0.5 and int(state.step) == 1
        print(json.dumps(sorted(m for m in sys.modules
                                if m.split(".")[0] in ("jax", "jaxlib", "repro"))))
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         env=env, timeout=240, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_launch_slice_runs_without_loading_jax_or_repro(tmp_path):
    """The launcher (slice 8) at smoke widths on the CPU: ``main`` trains,
    checkpoints and resumes through a gloo world of one; the sharded working
    table's three ops and the sharding rules on its mesh."""
    script = textwrap.dedent(f"""
        import json, sys
        import numpy as np
        import torch
        from repro_torch.configs import get_smoke_config
        from repro_torch.core.hbm_ps import ShardedWorkingTable, plan_a2a
        from repro_torch.launch import sharding as shd
        from repro_torch.launch import train as launch
        from repro_torch.launch.mesh import init_distributed, make_host_mesh

        argv = ["--arch", "olmoe-1b-7b", "--batch", "4", "--seq", "8", "--device", "cpu",
                "--ckpt-dir", {str(tmp_path)!r}, "--ckpt-every", "1"]
        launch.main(argv + ["--steps", "2"])
        launch.main(argv + ["--steps", "1", "--resume"])
        init_distributed("cpu")
        mesh = make_host_mesh()
        swt = ShardedWorkingTable(mesh, "model")
        table, slots = torch.randn(10, 4), torch.tensor([3, 1, 3, 9])
        assert torch.equal(swt.get_psum(table, slots), table[slots.long()])
        req, restore = plan_a2a(slots.numpy(), 1)
        assert torch.equal(swt.get_a2a(table, torch.from_numpy(req[0]),
                                       torch.from_numpy(restore[0])), table[slots.long()])
        swt.accumulate(table, slots, torch.ones(4, 4))
        cfg = get_smoke_config("yi-9b")
        assert shd.build_rules(cfg, mesh)["batch"] == ("data",)
        print(json.dumps(sorted(m for m in sys.modules
                                if m.split(".")[0] in ("jax", "jaxlib", "repro"))))
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         env=env, timeout=240, check=True)
    assert "resumed from step 2" in out.stdout
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_tensor_parallel_slice_runs_without_loading_jax_or_repro(tmp_path):
    """Tensor parallelism (slice 9) at smoke widths on the CPU: two gloo
    ranks train two steps through ``launch.train.run(model_parallel=2)``,
    and neither rank loads ``jax`` or a ``repro`` module."""
    script = textwrap.dedent(f"""
        import json, os, sys
        from repro_torch.configs import get_smoke_config
        from repro_torch.launch import train as launch
        from repro_torch.launch.mesh import init_distributed
        from repro_torch.train.train_step import TrainSettings
        init_distributed("cpu", init_method=os.environ["INIT_METHOD"])
        res = launch.run(get_smoke_config("olmoe-1b-7b"), TrainSettings(), steps=2, batch=4,
                         seq=8, model_parallel=2, ckpt_every=0, device="cpu")
        assert len(res.losses) == 2
        print(json.dumps(sorted(m for m in sys.modules
                                if m.split(".")[0] in ("jax", "jaxlib", "repro"))))
    """)
    procs = [subprocess.Popen(
        [sys.executable, "-c", script], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=dict(os.environ, PYTHONPATH=str(ROOT / "src"), RANK=str(r),
                            WORLD_SIZE="2", LOCAL_RANK=str(r), OMP_NUM_THREADS="1",
                            INIT_METHOD=f"file://{tmp_path / 'rendezvous'}")) for r in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
        assert json.loads(out.strip().splitlines()[-1]) == []


def test_dryrun_family_runs_without_loading_jax_or_repro(tmp_path):
    """The compile-analysis family (slice 11) on the CPU: the collectives
    module and ``launch/{roofline,op_analysis,inputs,dryrun,report,triage}``
    load, the CLI dry-runs a cell on a (2, 2) dry mesh into a results file,
    the report renders it and triage breaks a smoke cell down, and nothing
    loads ``jax`` or a ``repro`` module."""
    script = textwrap.dedent(f"""
        import json, sys
        import repro_torch.collectives
        from repro_torch.configs import ShapeSpec, get_smoke_config
        from repro_torch.launch import dryrun, inputs, op_analysis, report, roofline, triage
        from repro_torch.launch.mesh import DryMesh
        out = {str(tmp_path / "results.json")!r}
        dryrun.main(["--arch", "whisper-tiny", "--shape", "decode_32k", "--mesh", "2x2",
                     "--out", out])
        table = report.render(json.load(open(out)))
        assert "| whisper-tiny | decode_32k | 2x2 |" in table, table
        lines = triage.report(get_smoke_config("yi-9b"), ShapeSpec("t", "train", 64, 8),
                              DryMesh(2, 2))
        assert any("all_reduce" in ln for ln in lines), lines
        print(json.dumps(sorted(m for m in sys.modules
                                if m.split(".")[0] in ("jax", "jaxlib", "repro"))))
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         env=env, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
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
