"""The port's dense LM serving slice against the JAX reference, on the CPU.

Both sides start from the same weights: a parameter pytree laid out by the
reference's ``transformer.schema`` and drawn with numpy at ``init``'s scales
(the reference's ``init`` folds ``hash(path)`` into its keys, which Python
salts per process, so its weights change from run to run), given to JAX as
is and to the port through ``convert.lm_params_from_numpy``; one test takes
the reference's ``init`` tree itself through the same conversion. Tokens come from numpy. Both compute in
bf16 and sum in other orders (XLA's CPU dots and softmax vs PyTorch's), so
a bf16 rounding can flip on one side and not the other and grow through the
layers: logits and KV caches are held within 2e-2 of their largest
magnitude (``max |port - ref| <= 2e-2 * max |ref|``), the 2e-2 of the
reference's own decode test (``tests/test_models.py``) taken normwise. Over
20 weight seeds the worst such error was 0.0089 (phi3-mini), 0.0075
(nemotron), 0.0071 (yi), 0.0054 (granite).
The configs are the smoke configs of the four dense archs: yi-9b (GQA),
phi3-mini (MHA, head_dim 16), granite-20b (gelu, MQA) and nemotron-4-340b
(squared ReLU). On the CPU the port runs the kernels' plain versions; the
kernels themselves are held against those on the card
(``tests/test_torch_cuda.py``).
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke_config  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.common import ParamSpec as JParamSpec  # noqa: E402
from repro.models.attention import KVCache as JKVCache  # noqa: E402
from repro.serve import ServingCluster as JServingCluster  # noqa: E402
from repro.serve import ServingEngine as JServingEngine  # noqa: E402
from repro.serve.serve_step import greedy_sample as jgreedy_sample  # noqa: E402
from repro_torch.configs import ArchConfig, get_config, get_smoke_config  # noqa: E402
from repro_torch.convert import lm_params_from_numpy, publish_arrays  # noqa: E402
from repro_torch.core.tables import RowSchema, TableSpec  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.attention import KVCache, attention_block  # noqa: E402
from repro_torch.models.common import param_count  # noqa: E402
from repro_torch.serve import ServingCluster, ServingEngine  # noqa: E402
from repro_torch.serve.serve_step import (  # noqa: E402
    greedy_sample,
    make_decode_step,
    make_prefill_step,
)

DENSE = ["yi-9b", "phi3-mini-3.8b", "granite-20b", "nemotron-4-340b"]
TOL = 2e-2


def _np_params(jcfg, seed):
    """The reference's parameter pytree (of ``jcfg``'s family), drawn with
    numpy: normal leaves at ``init``'s scale (``ParamSpec.scale`` or
    1/sqrt(fan)), ones and zeros."""
    rng = np.random.default_rng(seed)

    def go(node):
        if isinstance(node, JParamSpec):
            if node.init in ("zeros", "ones"):
                return np.full(node.shape, float(node.init == "ones"), np.float32)
            fan = node.shape[node.fan_axis] if node.shape else 1
            scale = node.scale if node.scale is not None else 1.0 / math.sqrt(max(1, fan))
            return (rng.standard_normal(node.shape) * scale).astype(np.float32)
        return {k: go(node[k]) for k in sorted(node)}

    return go(jget_model(jcfg).schema(jcfg))


def _pair(arch, embedding_mode="dense", seed=0):
    """(reference cfg, port cfg, reference params, port params)."""
    jcfg = dataclasses.replace(jget_smoke_config(arch), embedding_mode=embedding_mode)
    tcfg = dataclasses.replace(get_smoke_config(arch), embedding_mode=embedding_mode)
    tree = _np_params(jcfg, seed)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, tree), lm_params_from_numpy(tcfg, tree,
                                                                             device="cpu")


def _close(got, want, tol=TOL):
    """max |got - want| <= tol * max |want|."""
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= tol * scale, f"max |diff| {err} > {tol} * max |ref| {scale}"


def _tokens(cfg, B=2, S=12, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_reference(arch):
    jcfg, tcfg, jp, tp = _pair(arch)
    toks = _tokens(jcfg)
    want, _ = JT.forward(jcfg, jp, jnp.asarray(toks))
    got, aux = TT.forward(tcfg, tp, torch.from_numpy(toks))
    assert got.dtype == torch.float32 and got.shape == (2, 12, jcfg.vocab_size)
    assert float(aux) == 0.0
    _close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ["yi-9b", "granite-20b"])
def test_reference_init_converts_and_prefill_matches(arch):
    """The reference's own ``T.init`` tree, as numpy, through
    ``lm_params_from_numpy``: the same leaves bit for bit (fp32, as
    stored; bf16 layers and ``lm_head`` on request), and the prefill
    agrees."""
    jcfg = dataclasses.replace(jget_smoke_config(arch), embedding_mode="dense")
    tcfg = dataclasses.replace(get_smoke_config(arch), embedding_mode="dense")
    jp = JT.init(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jp)
    tp = lm_params_from_numpy(tcfg, tree, device="cpu")
    np.testing.assert_array_equal(tp["layers"]["attn"]["wq"].numpy(),
                                  tree["layers"]["attn"]["wq"])
    np.testing.assert_array_equal(tp["lm_head"].numpy(), tree["lm_head"])
    tb = lm_params_from_numpy(tcfg, tree, device="cpu", dtype=torch.bfloat16)
    assert tb["layers"]["mlp"]["wi"].dtype == tb["lm_head"].dtype == torch.bfloat16
    assert tb["final_norm"].dtype == tb["embed"].dtype == torch.float32
    assert torch.equal(tb["layers"]["attn"]["wq"], tp["layers"]["attn"]["wq"].bfloat16())
    toks = _tokens(jcfg)
    want, _ = JT.prefill(jcfg, jp, jnp.asarray(toks))
    got, _ = TT.prefill(tcfg, tp, torch.from_numpy(toks))
    _close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_matches_reference(arch):
    jcfg, tcfg, jp, tp = _pair(arch)
    toks = _tokens(jcfg)
    want, jcache = JT.prefill(jcfg, jp, jnp.asarray(toks))
    got, cache = TT.prefill(tcfg, tp, torch.from_numpy(toks))
    assert got.shape == (2, 1, jcfg.vocab_size)
    assert cache.k.dtype == torch.bfloat16 and tuple(cache.k.shape) == jcache.k.shape
    _close(got.numpy(), np.asarray(want))
    _close(_f32(cache.k), _f32(jcache.k))
    _close(_f32(cache.v), _f32(jcache.v))


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_reference_teacher_forced(arch):
    """Prefill 8 tokens, then decode the next 4 fed the same tokens on both
    sides; every step's logits and the final caches agree, and the last
    step agrees with the full forward's last logits."""
    jcfg, tcfg, jp, tp = _pair(arch)
    toks = _tokens(jcfg)
    _, jc = JT.prefill(jcfg, jp, jnp.asarray(toks[:, :8]))
    _, tc = TT.prefill(tcfg, tp, torch.from_numpy(toks[:, :8]))
    jc = JKVCache(*(jnp.pad(a, ((0, 0),) * 3 + ((0, 4), (0, 0))) for a in jc))
    tc = KVCache(*(torch.nn.functional.pad(a, (0, 0, 0, 4)) for a in tc))
    step = make_decode_step(tcfg)
    for t in range(8, 12):
        want, jc = JT.decode_step(jcfg, jp, jnp.asarray(toks[:, t:t + 1]), jc, jnp.int32(t))
        got, tc = step(tp, {"token": torch.from_numpy(toks[:, t:t + 1])}, tc, t)
        _close(got.numpy(), np.asarray(want))
    _close(_f32(tc.k), _f32(jc.k))
    full, _ = TT.forward(tcfg, tp, torch.from_numpy(toks))
    _close(got[:, 0].numpy(), full[:, -1].numpy())


@pytest.mark.parametrize("S", [128, 256])
def test_flash_prefill_matches_reference_flash(S):
    """``attn_impl="flash"``: the Pallas kernel in interpret mode on the
    reference side, the kernel's plain version in the port."""
    jcfg, tcfg, jp, tp = _pair("yi-9b")
    toks = _tokens(jcfg, B=1, S=S, seed=S)
    want, jcache = JT.prefill(jcfg, jp, jnp.asarray(toks), attn_impl="flash")
    got, cache = make_prefill_step(tcfg, attn_impl="flash")(tp, {"tokens": torch.from_numpy(toks)})
    _close(got.numpy(), np.asarray(want))
    _close(_f32(cache.v), _f32(jcache.v))
    naive, _ = TT.prefill(tcfg, tp, torch.from_numpy(toks), attn_impl="naive")
    _close(got.numpy(), naive.numpy())


def test_hier_ps_serving_matches_reference(tmp_path):
    """One published ``tok_emb`` snapshot opened by both packages:
    ``lookup_device`` -> prefill -> 4 greedy decode steps, each step one
    ``lookup_device`` of the batch's tokens. The working tables are equal
    bitwise; logits within the tolerance; both sides are fed the
    reference's greedy tokens, and the port's own greedy choice agrees
    wherever the reference's top two logits are further apart than that."""
    jcfg, tcfg, jp, tp = _pair("yi-9b", embedding_mode="hier_ps")
    d, V = tcfg.d_model, tcfg.vocab_size
    spec = TableSpec("tok_emb", RowSchema.embedding(d))
    rows = (np.random.default_rng(3).normal(size=(V, d)) * 0.5).astype(np.float32)
    publish_arrays(str(tmp_path), n_nodes=2, dim=d,
                   tables={"tok_emb": (spec, np.arange(V, dtype=np.uint64), rows)})
    jeng = JServingEngine(JServingCluster(str(tmp_path)), device_hot_rows=64)
    teng = ServingEngine(ServingCluster(str(tmp_path)), device_hot_rows=64, device="cpu")
    prompts = _tokens(tcfg, B=2, S=16, seed=4).astype(np.uint64)

    def lookup(keys):
        js, jwt = jeng.lookup_device("tok_emb", keys)
        ts, twt = teng.lookup_device("tok_emb", keys)
        np.testing.assert_array_equal(ts, js)
        np.testing.assert_array_equal(twt.numpy(), np.asarray(jwt))
        np.testing.assert_array_equal(twt[torch.from_numpy(ts.astype(np.int64))].numpy(),
                                      rows[keys.astype(np.int64)])
        return (jnp.asarray(js), jwt), (torch.from_numpy(ts), twt)

    (js, jwt), (ts, twt) = lookup(prompts)
    want, jc = JT.prefill(jcfg, jp, js, working_table=jwt)
    got, tc = make_prefill_step(tcfg)(tp, {"tokens": ts, "working_table": twt})
    _close(got.numpy(), np.asarray(want))
    jc = JKVCache(*(jnp.pad(a, ((0, 0),) * 3 + ((0, 4), (0, 0))) for a in jc))
    tc = KVCache(*(torch.nn.functional.pad(a, (0, 0, 0, 4)) for a in tc))
    step = make_decode_step(tcfg)
    for i in range(4):
        w = np.asarray(want[:, -1], np.float32)
        top2 = np.sort(w, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 2 * TOL * np.abs(w).max()
        tok = np.asarray(jgreedy_sample(want))
        mine = greedy_sample(got).numpy()
        assert mine.dtype == np.int32 and mine.shape == (2, 1)
        np.testing.assert_array_equal(mine[clear], tok[clear])
        (js, jwt), (ts, twt) = lookup(tok.astype(np.uint64))
        want, jc = JT.decode_step(jcfg, jp, js, jc, jnp.int32(16 + i), working_table=jwt)
        got, tc = step(tp, {"token": ts, "working_table": twt}, tc, 16 + i)
        _close(got.numpy(), np.asarray(want))
    assert teng.counters.snapshot() == jeng.counters.snapshot()
    assert (dataclasses.asdict(teng.device_hot_stats("tok_emb"))
            == dataclasses.asdict(jeng.device_hot_stats("tok_emb")))


def test_cpu_path_launches_no_kernel():
    _, tcfg, _, tp = _pair("yi-9b")
    ops.reset_launch_counts()
    TT.prefill(tcfg, tp, torch.from_numpy(_tokens(tcfg, S=130)))
    assert set(ops.launch_counts().values()) == {0}


def test_init_is_seeded_per_leaf_and_stores_the_asked_dtype():
    cfg = get_smoke_config("yi-9b")
    a = TT.init(cfg, torch.Generator().manual_seed(5))
    b = TT.init(cfg, torch.Generator().manual_seed(5), dtype=torch.bfloat16)
    c = TT.init(cfg, torch.Generator().manual_seed(6))
    assert torch.equal(a["layers"]["attn"]["wq"].to(torch.bfloat16), b["layers"]["attn"]["wq"])
    assert not torch.equal(a["layers"]["attn"]["wq"], c["layers"]["attn"]["wq"])
    assert not torch.equal(a["layers"]["mlp"]["wi"], a["layers"]["mlp"]["wg"])
    assert b["layers"]["mlp"]["wo"].dtype == b["lm_head"].dtype == torch.bfloat16
    assert b["final_norm"].dtype == torch.float32 and torch.equal(b["final_norm"],
                                                                  torch.ones(cfg.d_model))
    assert "embed" not in a  # hier_ps: the embedding lives on the parameter server
    wq = a["layers"]["attn"]["wq"]
    assert abs(float(wq.std()) - cfg.d_model**-0.5) < 0.1 * cfg.d_model**-0.5
    assert param_count(TT.schema(cfg)) == sum(
        t.numel() for t in [a["final_norm"], a["lm_head"]]
        + [x for blk in a["layers"].values()
           for x in (blk.values() if isinstance(blk, dict) else [blk])])


def test_full_width_yi_9b_shapes_without_allocating():
    """Yi-9B at its published widths: the schema's sizes, as the reference
    counts them (no tensor is made)."""
    cfg = get_config("yi-9b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
            cfg.d_ff, cfg.vocab_size, cfg.embedding_mode) == (48, 4096, 32, 4, 128, 11008,
                                                              64000, "hier_ps")
    n = param_count(TT.schema(cfg))  # layers, final_norm and lm_head
    # the reference's count adds the PS-held tok_emb and leaves out final_norm
    assert n + cfg.vocab_size * cfg.d_model - cfg.d_model == cfg.param_count()
    assert 2 * n / 1e9 == pytest.approx(17.1, abs=0.05)  # bf16 GB without the embedding


def test_other_families_and_paths_resolve_and_compute():
    """``get_model`` resolves the hybrid, ssm and audio families; the ring
    cache computes a sliding-window decode (the token at position p against
    the ring of the last W positions equals it against the full cache with
    window W), and ``cross_kv`` attends the given K/V with no projection and
    no RoPE."""
    names = {arch: get_model(get_smoke_config(arch)).name
             for arch in ("hymba-1.5b", "xlstm-1.3b", "whisper-tiny")}
    assert names == {"hymba-1.5b": "hymba", "xlstm-1.3b": "xlstm", "whisper-tiny": "whisper"}
    cfg = get_smoke_config("yi-9b")
    assert isinstance(cfg, ArchConfig)
    Hkv, hd, W, P = cfg.n_kv_heads, cfg.resolved_head_dim, 4, 9
    p = {k: v[0] for k, v in TT.init(cfg, torch.Generator().manual_seed(0))["layers"]
         ["attn"].items()}
    g = torch.Generator().manual_seed(1)
    xs = torch.randn(1, P + 1, cfg.d_model, generator=g)
    _, kv = attention_block(xs[:, :P], p, cfg, positions=torch.arange(P), return_kv=True)
    full = KVCache(*(torch.nn.functional.pad(a, (0, 0, 0, 1)) for a in kv))
    ring = KVCache(*(torch.roll(a[:, :, P - W:], P % W, dims=2).clone() for a in kv))
    x = xs[:, P:]
    want, _ = attention_block(x, p, cfg, positions=torch.tensor([P]), cache=full, cache_pos=P,
                              q_offset=P, window=W, impl="naive")
    got, ring2 = attention_block(x, p, cfg, positions=torch.tensor([P]), cache=ring,
                                 cache_pos=P, q_offset=P, ring=True, impl="naive")
    assert ring2 is ring and torch.equal(ring.k[:, :, P % W], full.k[:, :, P])
    torch.testing.assert_close(got, want)
    k = torch.randn(1, Hkv, 7, hd, generator=g)
    v = torch.randn(1, Hkv, 7, hd, generator=g)
    got, _ = attention_block(x, p, cfg, positions=torch.tensor([P]), causal=False,
                             cross_kv=(k, v), impl="naive")
    q = (x @ p["wq"]).reshape(1, 1, cfg.n_heads, hd).transpose(1, 2)
    want = ops.attention(q, k, v, causal=False, impl="naive").transpose(1, 2).reshape(1, 1, -1)
    torch.testing.assert_close(got, want @ p["wo"])


def test_decode_past_the_cache_end_raises():
    """JAX clamps an overflowing ``dynamic_update_slice``; the port raises."""
    _, tcfg, _, tp = _pair("yi-9b")
    toks = torch.from_numpy(_tokens(tcfg, S=4))
    _, cache = TT.prefill(tcfg, tp, toks)
    with pytest.raises(ValueError, match="outside a cache"):
        TT.decode_step(tcfg, tp, toks[:, :1], cache, 4)
