"""Train-step factories, in PyTorch: the LM steps and the CTR steps.

``make_lm_train_step`` builds the LM step for any architecture of the zoo:
cross-entropy next-token loss (+ the MoE aux loss), gradient accumulation
over microbatches (a Python loop where the reference scans), remat inside
the model, AdamW. ``make_lm_train_step_hier`` is its ``hier_ps`` form, the
paper's technique on an LM (Algorithm 1 with a transformer for the tower):
the step also takes the pulled *working table* and its row-Adagrad
accumulator and returns both updated, the table's gradient going to
``kops.adagrad_update`` (the ``fused_adagrad`` kernel on the card); the host
commits them back through the ``PSClient`` session. On the card the
embedding gather, its backward (``scatter_add``), flash attention and the
MoE expert products are the port's kernels, through their autograd
Functions in ``kernels.ops``.

The CTR step: one pulled working set, k mini-batches (Algorithm 1
lines 11-15).

The reference's ``make_ctr_train_step`` runs the k mini-batches in one
jitted ``lax.scan``; here they are a Python loop, run eagerly. Each
mini-batch: bag forward, tower, BCE, backward (the bag's backward through
the ``scatter_add`` kernel on the card), AdamW on the tower, then
row-Adagrad on the working table through ``kops.adagrad_update`` (the
``fused_adagrad`` kernel on the card) — before the next mini-batch sees the
table (Algorithm 1 line 14: parameters synchronised after every
mini-batch). ``make_ctr_train_step_grouped`` does the same over one
working table per slot group.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from repro_torch import collectives as coll
from repro_torch.configs import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import ctr as ctr_model
from repro_torch.models import get_model
from repro_torch.models.common import (
    constrain_like_params,
    data_dims,
    data_group,
    local_range,
    model_group,
)
from repro_torch.train.optim import AdamW, tree_leaves, tree_map


@dataclass(frozen=True)
class TrainSettings:
    optimizer: AdamW = field(default_factory=AdamW)
    microbatches: int = 1
    attn_impl: str = "auto"
    remat: bool = True
    moe_aux_coef: float = 0.01
    row_lr: float = 0.05  # adagrad lr for hier-PS working rows


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  vocab: int | None = None) -> torch.Tensor:
    """Mean next-token CE. logits: [B, S, V] fp32; targets: [B, S] int. The
    target's logit is gathered: the reference's one-hot contraction has one
    nonzero term per position, so it is the same value, without a second
    [B, S, V] tensor. Logits narrower than ``vocab`` are this rank's columns
    of vocab-sharded logits (tensor parallelism over ``model``): the loss
    is then reduced over the ``model`` group (:class:`_VocabParallelCE`)."""
    if vocab is not None and logits.shape[-1] < vocab:
        return _VocabParallelCE.apply(logits, targets, *local_range(vocab, logits.shape[-1]))
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, targets.long().unsqueeze(-1)).squeeze(-1)
    return torch.mean(lse - picked)


class _VocabParallelCE(torch.autograd.Function):
    """Megatron's vocab-parallel CE over the ``model`` group, each rank
    holding logit columns [lo, hi): the global max and the sum of
    exponentials are all-reduced, the target's logit comes from the rank
    that owns it (a sum of one nonzero term); the backward is ``softmax -
    onehot`` on the local columns, over the number of positions."""

    @staticmethod
    def forward(ctx, logits, targets, lo, hi):
        group = model_group()
        m = logits.max(dim=-1).values
        coll.all_reduce(m, coll.ReduceOp.MAX, group=group)
        e = torch.exp(logits - m.unsqueeze(-1))
        s = e.sum(dim=-1)
        t = targets.long()
        mine = (t >= lo) & (t < hi)
        picked = torch.gather(logits, -1, (t - lo).clamp(0, hi - lo - 1).unsqueeze(-1))
        picked = torch.where(mine, picked.squeeze(-1), 0.0)
        sums = torch.stack([s, picked])
        coll.all_reduce(sums, coll.ReduceOp.SUM, group=group)
        lse = torch.log(sums[0]) + m
        ctx.save_for_backward(e, sums[0], t, mine)
        ctx.lo, ctx.hi = lo, hi
        return torch.mean(lse - sums[1])

    @staticmethod
    def backward(ctx, g):
        e, s, t, mine = ctx.saved_tensors
        grad = e / s.unsqueeze(-1)
        idx = (t - ctx.lo).clamp(0, ctx.hi - ctx.lo - 1).unsqueeze(-1)
        grad.scatter_add_(-1, idx, -mine.to(grad.dtype).unsqueeze(-1))
        return grad * (g / t.numel()), None, None, None


def _make_loss_fn(cfg: ArchConfig, settings: TrainSettings, hier: bool):
    model = get_model(cfg)

    def loss_fn(params, working_table, micro):
        kwargs: dict = {}
        if cfg.family == "audio":
            kwargs["frames"] = micro["frames"]
        if cfg.family == "vlm":
            kwargs["image_embeds"] = micro["image_embeds"]
        if hier:
            kwargs["working_table"] = working_table
        logits, aux = model.forward(
            cfg, params, micro["tokens"],
            attn_impl=settings.attn_impl, remat=settings.remat, **kwargs,
        )
        if cfg.family == "vlm":  # image prefix positions carry no LM loss
            logits = logits[:, cfg.n_image_tokens:]
        loss = cross_entropy(logits, micro["targets"], cfg.vocab_size)
        return loss + settings.moe_aux_coef * aux, (loss, aux)

    return loss_fn


def make_lm_grads(cfg: ArchConfig, settings: TrainSettings = TrainSettings(), *,
                  hier: bool = False):
    """The gradient half of the LM step.

    grads(params, batch, working_table=None)
      -> (param grads, working-table grad or None, metrics)
    The batch splits into ``settings.microbatches`` along its first dim; each
    microbatch's gradients (fp32) are summed and the sum divided by their
    number, as the reference's scan accumulates. metrics: {"loss",
    "moe_aux"}, the microbatch means, device scalars. The tree {"params",
    "metrics"[, "working_table"]} then goes once through
    ``constrain_like_params``, where the reference constrains each
    microbatch's gradients: the launcher's hook averages it over the
    data-parallel group (``launch/sharding.py``); with no hook installed it
    is returned as it is. Under FSDP the gradients of the leaves cut over
    ``data`` are reduce-scattered onto this rank's shards in each
    microbatch's backward (``common.gather_weights``), as the reference's
    constraint reduce-scatters them."""
    loss_fn = _make_loss_fn(cfg, settings, hier)
    n_micro = settings.microbatches

    def grads(params, batch, working_table=None):
        p = tree_map(lambda t: t.detach().requires_grad_(), params)
        leaves = tree_leaves(p)
        wt = working_table.detach().requires_grad_() if hier else None
        wrt = leaves + ([wt] if hier else [])
        acc, losses, auxs = None, [], []
        for i in range(n_micro):
            micro = {k: v.reshape((n_micro, v.shape[0] // n_micro) + v.shape[1:])[i]
                     for k, v in batch.items()}
            total, (loss, aux) = loss_fn(p, wt, micro)
            gs = torch.autograd.grad(total, wrt)
            if acc is None:  # own every buffer: autograd may hand one to two leaves
                acc, seen = [], set()
                for g in gs:
                    g = g.float()
                    ptr = g.untyped_storage().data_ptr()
                    acc.append(g.clone() if ptr in seen else g)
                    seen.add(ptr)
            else:
                for a, g in zip(acc, gs):
                    a.add_(g)
            losses.append(loss.detach())
            auxs.append(aux.detach())
            del total, gs
        acc = [a.div_(n_micro) for a in acc]
        it = iter(acc)
        out = {"params": tree_map(lambda _: next(it), params),
               "metrics": {"loss": torch.stack(losses).mean(), "moe_aux": torch.stack(auxs).mean()}}
        if hier:
            out["working_table"] = acc[-1]
        out = constrain_like_params(out)
        return out["params"], out.get("working_table"), out["metrics"]

    return grads


def replicated_leaves(cfg: ArchConfig, params, axis: str = "model", dims=None):
    """Tree of bools beside ``params``: whether each leaf is whole over the
    mesh axis ``axis`` (``"model"`` or ``"data"``), rather than this rank's
    shard over it. ``dims``: each leaf's dim cut over ``data``, as
    ``sharding.data_dims`` gives it (default the installed tree,
    ``common.data_dims()``; none with nothing installed); a leaf is whole
    over ``model`` where its other dims are its schema's."""
    schema = get_model(cfg).schema(cfg)
    dims = data_dims() if dims is None else dims
    if dims is None:
        dims = tree_map(lambda _: None, params)
    if axis == "data":
        return tree_map(lambda t, dim: dim is None, params, dims)

    def whole(t, spec, dim):  # an mLSTM projection cut inside its heads has a dim fewer
        cut = None if dim is None else dim % len(spec.shape)
        return t.dim() == len(spec.shape) and all(
            n == full for i, (n, full) in enumerate(zip(t.shape, spec.shape)) if i != cut)

    return tree_map(whole, params, schema, dims)


def _updater(opt, cfg: ArchConfig):
    """``opt.update``; under tensor parallelism or FSDP (a ``model`` or
    ``data`` group installed) it is told over which axes each leaf is
    whole (:func:`replicated_leaves` of the first step's params), so
    AdamW's clip norm sums the shards of the others over their groups
    (``optim.global_norm``)."""
    mask = []

    def update(grads, opt_state, params):
        if model_group() is None and data_group() is None:
            return opt.update(grads, opt_state, params)
        if not mask:
            mask.append({axis: replicated_leaves(cfg, params, axis) for axis in ("model", "data")})
        return opt.update(grads, opt_state, params, replicated=mask[0])

    return update


def make_lm_train_step(cfg: ArchConfig, settings: TrainSettings = TrainSettings()):
    """Dense-embedding LM step.

    step(params, opt_state, batch) -> (params, opt_state, metrics)
    batch: {"tokens": [B, S] int, "targets": [B, S] int,
            ["frames"|"image_embeds"]: the family's extra inputs}
    The inputs are not modified."""
    if cfg.embedding_mode != "dense":
        raise ValueError(f"{cfg.name}: make_lm_train_step takes embedding_mode 'dense', got "
                         f"{cfg.embedding_mode!r}")
    grads_fn = make_lm_grads(cfg, settings, hier=False)
    update = _updater(settings.optimizer, cfg)

    def step(params, opt_state, batch):
        grads, _, metrics = grads_fn(params, batch)
        new_params, new_opt = update(grads, opt_state, params)
        return new_params, new_opt, metrics

    return step


def make_lm_train_step_hier(cfg: ArchConfig, settings: TrainSettings = TrainSettings()):
    """hier_ps LM step: working-table rows updated with row-Adagrad.

    step(params, opt_state, batch, working_table, row_accum)
      -> (params, opt_state, metrics, new_table, new_accum)
    batch["tokens"] holds *working slots*; batch["targets"] holds vocab ids.
    The inputs are not modified."""
    if cfg.embedding_mode != "hier_ps":
        raise ValueError(f"{cfg.name}: make_lm_train_step_hier takes embedding_mode "
                         f"'hier_ps', got {cfg.embedding_mode!r}")
    grads_fn = make_lm_grads(cfg, settings, hier=True)
    update = _updater(settings.optimizer, cfg)

    def step(params, opt_state, batch, working_table, row_accum):
        grads, table_grad, metrics = grads_fn(params, batch, working_table)
        new_params, new_opt = update(grads, opt_state, params)
        new_table, new_accum = kops.adagrad_update(working_table, row_accum, table_grad,
                                                   settings.row_lr)
        return new_params, new_opt, metrics, new_table, new_accum

    return step


def make_ctr_train_step(ctr_cfg, row_lr: float = 0.05, tower_opt: AdamW = AdamW(lr=1e-3)):
    """step(tower, opt_state, working_table, row_accum, minibatches)
      -> (tower, opt_state, table, accum, metrics)

    minibatches: dict of stacked [k, mb, ...] tensors (slot_ids, slot_of,
    valid, labels) on the table's device. The inputs are not modified;
    ``metrics["loss"]`` is the mean mini-batch loss, a device scalar."""

    def step(tower, opt_state, working_table, row_accum, minibatches):
        table, accum = working_table, row_accum
        losses = []
        for i in range(minibatches["labels"].shape[0]):
            mb = {k: v[i] for k, v in minibatches.items()}
            tw = {k: v.detach().requires_grad_() for k, v in tower.items()}
            tb = table.detach().requires_grad_()
            loss = ctr_model.loss_fn(
                ctr_cfg, tw, tb, mb["slot_ids"], mb["slot_of"], mb["valid"], mb["labels"]
            )
            grads = torch.autograd.grad(loss, [*tw.values(), tb])
            tower, opt_state = tower_opt.update(dict(zip(tw, grads[:-1])), opt_state, tower)
            table, accum = kops.adagrad_update(table, accum, grads[-1], row_lr)
            losses.append(loss.detach())
        return tower, opt_state, table, accum, {"loss": torch.stack(losses).mean()}

    return step


def make_ctr_train_step_grouped(ctr_cfg, row_lr: float = 0.05,
                                tower_opt: AdamW = AdamW(lr=1e-3)):
    """Multi-table CTR step: one working table per slot group.

    step(tower, opt_state, tables, accums, minibatches)
      -> (tower, opt_state, tables, accums, metrics)
    tables/accums: {group_name: [n_working_g, emb_g]} per named PS table
    minibatches: {"labels": [k, mb],
                  "inputs": {group_name: {"slot_ids","slot_of","valid"}
                             each stacked [k, mb, nnz_g]}}
    The inputs are not modified; ``metrics["loss"]`` is the mean mini-batch
    loss, a device scalar."""

    def step(tower, opt_state, tables, accums, minibatches):
        losses = []
        for i in range(minibatches["labels"].shape[0]):
            inputs = {name: {k: v[i] for k, v in inp.items()}
                      for name, inp in minibatches["inputs"].items()}
            tw = {k: v.detach().requires_grad_() for k, v in tower.items()}
            tb = {k: v.detach().requires_grad_() for k, v in tables.items()}
            loss = ctr_model.loss_fn_grouped(ctr_cfg, tw, tb, inputs, minibatches["labels"][i])
            grads = torch.autograd.grad(loss, [*tw.values(), *tb.values()])
            tower, opt_state = tower_opt.update(dict(zip(tw, grads[:len(tw)])), opt_state, tower)
            # synchronise after every mini-batch (Algorithm 1 line 14),
            # independently per table
            new_tables, new_accums = {}, {}
            for name, g in zip(tb, grads[len(tw):]):
                new_tables[name], new_accums[name] = kops.adagrad_update(
                    tables[name], accums[name], g, row_lr
                )
            tables, accums = new_tables, new_accums
            losses.append(loss.detach())
        return tower, opt_state, tables, accums, {"loss": torch.stack(losses).mean()}

    return step
