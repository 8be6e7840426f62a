"""The ZeRO stages and the data/sequence-parallel training step over the
port's ranks (parallel/tp.py). JAX has no counterpart module: there GSPMD
derives all of this from the placements of parallel/sharding.py.

Why not FSDP2 (`torch.distributed.fsdp.fully_shard`). It needs a process
group whose collectives take the parameters' device. Ranks that share one
card run gloo (NCCL refuses two ranks on a card), and gloo moves CUDA
tensors through host sockets, so FSDP2 there would route every gather
through the host. The world's own collectives (`World.all_gather`,
`reduce_scatter`, `sum`, `shift`) go through the card's exchange buffers
on a shared card, NCCL's all-gather with a card a rank, and gloo on the
CPU, so the CPU tests and the card run one code path. The stages are
written out over them:

  * fsdp (ZeRO-3): each rank holds its fp32 shard of every leaf with an
    `embed` axis (sharding.param_shardings over the combined fsdp x sp
    width) and of both Adam moments. A leaf is read through `_Gather`:
    the shard cast to the compute dtype and THEN all-gathered (the gathers
    move compute-dtype bytes, as JAX's `cast_params_for_compute` makes
    them), whose backward reduce-scatters the fp32 gradient over the same
    group. A decoder or ViT layer's leaves are gathered when the layer
    runs (`gathered`, wrapped around the layer's body by the model) and
    dropped when it returns; under a remat policy the backward's
    recompute gathers them again. Without remat, autograd keeps the
    gathered copies its products saved until their backward. The other
    leaves (embedding, head, norms, compressor) are gathered once a
    microbatch (`compute`).
  * zero2: the parameters are whole on every rank, the moments sharded as
    under fsdp. After the backward the gradients are reduce-scattered;
    the rank owning a chunk updates it with its moments, and the updated
    chunks are all-gathered into every rank's whole parameter.
  * ddp: everything whole; the gradients are summed over the ranks.

A leaf with no embed axis (or an indivisible one) is whole over (fsdp,
sp) in every mode: its gradient is summed over every rank that computes
part of the loss (dp, fsdp and sp, at the rank's tp coordinate), and with
dp > 1 a sharded gradient is summed over dp after its reduce-scatter.

Tensor parallelism (tp > 1). Every mode also cuts a leaf's heads or MLP
columns over tp (JAX's `param_specs`; under fsdp a leaf with both axes is
cut on both, sharding.Placement), a rank holding its tp slice for good;
the ZeRO gathers and reduce-scatters run over the (fsdp, sp) ranks of the
rank's tp coordinate. The model's three parts carry a `TpGroup`: the
row-parallel products (o_proj, down_proj, the ViT's o_proj and fc2, the
projector's fc2) sum over the tp group with an identity backward, and the
column-parallel inputs (q/k/v, gate/up, fc1, the projector's fc1) sum
their gradient over it. A tp group computes one loss from the same rows.
LoRA adapters stay whole on every rank in every mode (JAX's param_specs
name no adapter leaf), and the products use the rank's columns of B or
rows of A (utils/quant.py). Their gradients are then partial over the tp
group, all but a row-parallel layer's B and scale, which every rank of
the group computes whole from the same sum: the partial ones are summed
over the tp group and the loss ranks at once (every rank), the others
over the loss ranks as any whole leaf.

The step (`RankTrainer.step`). Each rank takes its rows of the batch (its
index on the (dp, fsdp) width) and, under sp, its T / sp slice of every
row field (labels arrive shifted, train/loss.py, so no target is lost at a
cut). The loss is the GLOBAL mean over supervised tokens: a rank
backpropagates its CE SUM over the microbatch's supervised-token count,
which every rank reads off the whole host batch, and the scalars are
summed over the (dp, fsdp, sp) ranks. The packed visual fields' packing
axis is cut over the W = dp x fsdp x sp ranks as JAX places it
(`sharding.batch_field_spec`; whole when a field does not divide, as JAX
then replicates it): a rank encodes its 1/W of the patches, each ViT
layer's keys and values and the compressor's are gathered over the W
ranks and reduce-scattered back in the backward, the region pooling is
summed over them (fp32, rank order) before the rank's query shard reads
it, and the visual tokens are gathered whole for the splice
(`VisualShard`). The encoder's gradient is then summed with the rest.
`grad_norm` counts each chunk of a sharded gradient once (a sum of
squares over the ranks holding its chunks: the (fsdp, sp) group, the tp
group, or both) and each whole leaf once, every leaf included, frozen or
not; the optimizer's per-group clip takes the same norm.

Dispatch. Rank 0 holds the `Trainer`; each rank's `RankTrainer` is made
and driven by `World.call` (`bind=True`: the followers keep theirs under a
handle), and every function here that a dispatch names leaves the
follower's inference mode for its body. Checkpoints: each rank writes its
shards of the trainable leaves and of the optimizer state with
`torch.save` under `<checkpoint_dir>/rank<r>of<n>/` (utils/checkpoint.py),
so a resumed run continues bit for bit.

Refused: sp > 1 without a ring attn_impl (each rank would attend only
its own slice), and rows or sequence lengths that do not divide over the
data width and sp.
"""

from __future__ import annotations

import contextlib
import os
import re

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from oryx_tpu_torch.parallel import sharding
from oryx_tpu_torch.parallel import tp as tp_lib
from oryx_tpu_torch.utils.quant import LORA_LEAVES

MODES = ("fsdp", "zero2", "ddp")
_LAYER = re.compile(r"^(llm|vit)\.layers\.\d+\.")
ROW_FIELDS = ("token_ids", "visual_idx", "is_visual", "attn_mask",
              "positions", "labels", "text_segment_ids")


def gathered(fn, module: nn.Module):
    """`fn` with `module`'s sharded leaves gathered while it runs (a
    decoder or ViT layer of a ZeRO-3 rank); `fn` itself otherwise."""
    zero = getattr(module, "zero", None)
    if zero is None:
        return fn

    def run(*args, **kwargs):
        with zero.layer(module):
            return fn(*args, **kwargs)

    return run


class _Gather(torch.autograd.Function):
    """x -> the group's x concatenated along `dim` in rank order, cast to
    `dtype` before the all-gather (None: x's own); the backward
    reduce-scatters the gradient in fp32 to the owners, returned in x's
    dtype. A ZeRO-3 rank's leaf shard, or a rank's shard of the packed
    visual buffer's activations."""

    @staticmethod
    def forward(ctx, x, world, group, dim, dtype):
        ctx.world, ctx.group, ctx.dim, ctx.dtype = world, group, dim, x.dtype
        x = x.detach()
        if dtype is not None and x.is_floating_point() and x.dtype != dtype:
            x = x.to(dtype)
        return world.all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        gs = ctx.world.reduce_scatter(g, ctx.group, ctx.dim)
        return gs.to(ctx.dtype), None, None, None, None


class _GroupSum(torch.autograd.Function):
    """The group's sum of x (fp32, rank order, in x's dtype). `back_sum`
    False: the row-parallel sum of tensor parallelism, whose backward is
    the identity (every rank of the group computes the same loss from the
    sum). True: a sum each rank's loss reads, whose backward sums the
    gradient over the group as well."""

    @staticmethod
    def forward(ctx, x, world, group, back_sum):
        ctx.world, ctx.group, ctx.back_sum = world, group, back_sum
        return world.sum(x.detach(), group)

    @staticmethod
    def backward(ctx, g):
        if ctx.back_sum:
            g = ctx.world.sum(g, ctx.group)
        return g, None, None, None


class _ColumnIn(torch.autograd.Function):
    """The input of a column-parallel product: the identity forward; the
    backward sums the input's gradient over the tp group (each rank's
    columns give a part of it)."""

    @staticmethod
    def forward(ctx, x, world, group):
        ctx.world, ctx.group = world, group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.world.sum(g, ctx.group), None, None


class TpGroup:
    """A training rank's tensor-parallel group, carried as `tp` by the
    model's three parts (in place of serving's World): `all_reduce` is
    the row-parallel sum of o_proj, down_proj, the ViT's o_proj and fc2
    and the projector's fc2 (identity backward), `enter` the
    column-parallel input of q/k/v, gate/up, fc1 and the projector's fc1
    (a group sum in the backward). Under fsdp x tp the world is larger
    than the group, so these sum over the group, not the world."""

    def __init__(self, world, group):
        self.world = world
        self.group = list(group)
        self.size = len(self.group)

    @property
    def index(self) -> int:
        """This rank's place in the group (the cut its leaves hold)."""
        return self.group.index(self.world.rank)

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        if op != "sum":
            raise ValueError(f"a training tp group sums; op={op!r}")
        return _GroupSum.apply(x, self.world, self.group, False)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return _ColumnIn.apply(x, self.world, self.group)


class VisualShard:
    """A rank's 1/W of a microbatch's packed visual buffer, W the data
    width dp x fsdp x sp (JAX's `batch_field_spec`): the rank encodes its
    patches and its compressor queries; the ViT's keys and values, the
    compressor's keys and values and its visual tokens are gathered over
    the group (reduce-scattered back in the backward), and the region
    pooling is summed over it. `segment_ids` / `region_ids`: the whole
    buffer's ids (the gathered keys' segments)."""

    def __init__(self, world, group, segment_ids, region_ids):
        self.world = world
        self.group = list(group)
        self.segment_ids = segment_ids
        self.region_ids = region_ids

    def gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        return _Gather.apply(x, self.world, self.group, dim, None)

    def gather_kv(self, k: torch.Tensor, v: torch.Tensor) -> tuple:
        """The whole buffer's keys and values ([1, P, heads, D] each) from
        every rank's rows, one gather for the two."""
        kv = self.gather(torch.cat([k, v], -1), 1)
        return tuple(t.contiguous() for t in kv.chunk(2, -1))

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return _GroupSum.apply(x, self.world, self.group, True)


def _swap(mod: nn.Module, name: str, value) -> tuple:
    order = list(mod._parameters)
    p = mod._parameters.pop(name)
    setattr(mod, name, value)
    return mod, name, p, order


def _restore(swapped) -> None:
    """Put the parameters back, in their order (`names` pairs each
    parameter with its gradient by position)."""
    for mod, name, p, order in reversed(swapped):
        delattr(mod, name)
        mod._parameters[name] = p
        if list(mod._parameters) != order:
            held = dict(mod._parameters)
            mod._parameters.clear()
            mod._parameters.update((k, held[k]) for k in order)


class Gatherer:
    """Gathers a rank's sharded leaves over `shard_group` (the (fsdp, sp)
    ranks), cast to `dtype` first (None: each leaf's own). `dims` maps
    each sharded parameter (by id) to its split dim. A serving rank's
    layers carry one (`serving_gatherer`); a `RankTrainer` is one."""

    def __init__(self, world, shard_group, dtype=None):
        self.world = world
        self.shard_group = list(shard_group)
        self.dtype = dtype
        self.dims: dict[int, int] = {}

    def attach(self, model: nn.Module, places: dict) -> None:
        """Hook `model`'s decoder and ViT layers: their sharded leaves (by
        `places`) are gathered as each layer runs."""
        self.dims = {id(p): places[n].dim
                     for n, p in model.named_parameters()
                     if places[n].split}
        for part in (model.llm, model.vit):
            for layer in part.layers:
                layer.zero = self

    @contextlib.contextmanager
    def layer(self, module: nn.Module):
        """A layer's sharded leaves gathered while the block runs."""
        swapped = []
        try:
            for mod in module.modules():
                for name, p in list(mod._parameters.items()):
                    if p is not None and id(p) in self.dims:
                        swapped.append(_swap(mod, name, _Gather.apply(
                            p, self.world, self.shard_group,
                            self.dims[id(p)], self.dtype or p.dtype)))
            yield
        finally:
            _restore(swapped)


def serving_gatherer(model: nn.Module, places: dict, world, mesh_shape
                     ) -> Gatherer:
    """A serving rank's gatherer for `model` (its layer leaves sharded by
    `places`), attached to its layers; `model.llm.zero` names it, which
    sends the rank's decode down the eager route (a CUDA graph cannot
    capture a collective over the host)."""
    g = Gatherer(world, sharding.axis_group(mesh_shape, world.rank,
                                            ("fsdp", "sp")))
    g.attach(model, places)
    model.llm.zero = g
    return g


class RankTrainer(Gatherer):
    """One rank's share of a data/sequence-parallel training run: its
    shards of the model and the optimizer state, its place on the mesh and
    the groups it meets. Built on every rank by one dispatch (`Trainer`).

    source: None (each rank draws the seeded init of cfg.train.seed, as
    the one-device Trainer does) or the whole model's state dict (CPU
    tensors, sent by value)."""

    def __init__(self, cfg, source, mode: str, mesh_shape):
        from oryx_tpu_torch.models import oryx
        from oryx_tpu_torch.train import step as step_lib
        from oryx_tpu_torch.train.optimizer import GROUPS, make_optimizer
        from oryx_tpu_torch.train.trainer import prepare_params, setup_lora

        if mode not in MODES:
            raise ValueError(f"sharding_mode={mode!r}: one of {MODES}")
        self.world = tp_lib.current()
        self.cfg, self.mode = cfg, mode
        self.shape = tuple(mesh_shape)
        dp, fsdp, tp, sp = self.shape
        if sp > 1 and not cfg.attn_impl.startswith("ring"):
            raise ValueError(
                f"mesh sp={sp} needs attn_impl 'ring' or 'ring_flash', "
                f"not {cfg.attn_impl!r}")
        rank = self.world.rank
        self.coords = sharding.mesh_coords(self.shape, rank)
        self.shard_group = sharding.axis_group(self.shape, rank,
                                               ("fsdp", "sp"))
        self.dp_group = sharding.axis_group(self.shape, rank, "dp")
        self.loss_group = sharding.axis_group(self.shape, rank,
                                              ("dp", "fsdp", "sp"))
        self.every_group = sharding.axis_group(self.shape, rank,
                                               sharding.AXES)
        self.sp_group = tuple(sharding.axis_group(self.shape, rank, "sp"))
        self.tp_group = sharding.axis_group(self.shape, rank, "tp")
        self.vit_rows = None
        self.data_width = dp * fsdp
        self.data_index = self.coords["dp"] * fsdp + self.coords["fsdp"]
        device = self.world.device
        self.device = device
        self.dtype = oryx.compute_dtype(cfg)

        Gatherer.__init__(self, self.world, self.shard_group, self.dtype)
        if source is None:
            gen = torch.Generator(device).manual_seed(cfg.train.seed)
            model = oryx.init_params(cfg, gen, device=device)
        else:
            # Copies: a follower unpickles the state in inference mode,
            # and autograd refuses inference tensors.
            model = sharding.frozen_model(
                cfg, {n: t.to(device).clone() for n, t in source.items()})
        model = setup_lora(cfg, model)
        self.tx = make_optimizer(cfg.train, model)
        prepare_params(model, self.tx.mask, self.dtype)
        # Placements: of the parameters (fsdp shards them) and of the
        # optimizer state (sharded under fsdp and zero2).
        mesh = _Shape(self.shape)
        opt_mode = "fsdp" if mode in ("fsdp", "zero2") else "ddp"
        self.opt_place = sharding.param_shardings(mesh, model, opt_mode,
                                                  rank=rank)
        self.param_place = (self.opt_place if mode == "fsdp" else
                            {n: p.tp_only()
                             for n, p in self.opt_place.items()})
        with torch.no_grad():
            for name, p in list(model.named_parameters()):
                place = self.param_place[name]
                if place.split or place.tp is not None:
                    owner, _, leaf = name.rpartition(".")
                    mod = model.get_submodule(owner)
                    mod._parameters[leaf] = nn.Parameter(
                        place.take(p).clone(), requires_grad=True)
        self.names = [n for n, _ in model.named_parameters()]
        self.tp_partial = _tp_partial(self.names, self.param_place)
        if tp > 1:
            # Each rank holds its heads and MLP columns; the model's
            # row-parallel sums and column-parallel inputs meet the group.
            group = TpGroup(self.world, self.tp_group)
            for part in (model.llm, model.vit, model.compressor):
                part.tp = group
        if mode == "fsdp":
            model.zero = self
            self.attach(model, self.param_place)
        # AdamW.init's state, each moment at the optimizer's placement.
        params = dict(model.named_parameters())
        opt = {"count": {g: 0 for g in GROUPS},
               "lr_count": {g: 0 for g in GROUPS}, "mu": {}, "nu": {}}
        for n in self.tx.trainable():
            like = self._opt_view(n, params[n])
            opt["mu"][n] = torch.zeros_like(like, dtype=self.tx.mu_dtype)
            opt["nu"][n] = torch.zeros_like(like, dtype=torch.float32)
        self.tx.norm_fn = self.global_norm
        self.state = step_lib.TrainState(step=0, params=model,
                                         opt_state=opt)
        self.grad_bytes = 0
        self.ckpt = None

    # ---- the gathers --------------------------------------------------------

    @contextlib.contextmanager
    def compute(self, model: nn.Module, dtype: torch.dtype):
        """The microbatch's compute view (train/step.compute_params): the
        sharded leaves outside the layers gathered in `dtype`, the whole
        floating leaves cast; a layer's sharded leaves are left for
        `layer`."""
        swapped = []
        try:
            for mname, mod in model.named_modules():
                in_layer = bool(_LAYER.match(mname + "."))
                for name, p in list(mod._parameters.items()):
                    if p is None:
                        continue
                    if id(p) in self.dims:
                        if in_layer:
                            continue
                        swapped.append(_swap(mod, name, _Gather.apply(
                            p, self.world, self.shard_group,
                            self.dims[id(p)], dtype)))
                    elif p.is_floating_point() and p.dtype != dtype:
                        swapped.append(_swap(mod, name, p.to(dtype)))
            yield
        finally:
            _restore(swapped)

    # ---- reductions ---------------------------------------------------------

    def global_norm(self, grads: dict) -> torch.Tensor:
        """sqrt of the sum of squares of the gradient tree (grads in the
        optimizer's layout): each chunk of a sharded leaf once (summed over
        the ranks that hold its chunks: the (fsdp, sp) group, the tp group,
        or both), each whole leaf once."""
        groups = {("fsdp", "sp"): self.shard_group, ("tp",): self.tp_group,
                  ("fsdp", "sp", "tp"): sharding.axis_group(
                      self.shape, self.world.rank, ("fsdp", "sp", "tp"))}
        dev = self.device
        acc = {k: torch.zeros((), dtype=torch.float32, device=dev)
               for k in [()] + list(groups)}
        for n, g in grads.items():
            sq = torch.linalg.vector_norm(g, dtype=torch.float32) ** 2
            place = self.opt_place[n]
            key = (("fsdp", "sp") if place.split else ()) + (
                ("tp",) if place.tp is not None else ())
            acc[key] = acc[key] + sq
        total = acc[()]
        for key, group in groups.items():
            total = total + (self.world.sum(acc[key], group)
                             if len(group) > 1 else acc[key])
        return torch.sqrt(total)

    def _sum_into(self, grads: list, idx: list[int], group) -> None:
        """grads[i] for i in `idx` replaced by their sums over `group`,
        a collective a bucket of at most EXCHANGE_BYTES (a larger leaf
        alone), so the gradients never all exist twice."""
        if len(group) == 1 or not idx:
            return
        bucket, size = [], 0
        for k, i in enumerate(idx):
            bucket.append(i)
            size += grads[i].numel() * 4
            if size < tp_lib.EXCHANGE_BYTES and k + 1 < len(idx):
                continue
            flat = self.world.sum(torch.cat(
                [grads[j].float().reshape(-1) for j in bucket]), group)
            off = 0
            for j in bucket:
                g = grads[j]
                grads[j] = flat[off:off + g.numel()].view(g.shape).to(g.dtype)
                off += g.numel()
            bucket, size = [], 0

    def reduce(self, grads: list) -> None:
        """In place: gradients as the backward left them (a sharded leaf's
        chunk already reduce-scattered under fsdp; whole local gradients
        otherwise) -> the optimizer's layout, summed over the loss ranks.
        Each replaced gradient is freed as its sum lands."""
        whole, chunks, partial = [], [], []
        for i, n in enumerate(self.names):
            opt, par = self.opt_place[n], self.param_place[n]
            if par.split:
                chunks.append(i)
            elif opt.split:
                g, grads[i] = grads[i], None
                grads[i] = self.world.reduce_scatter(
                    g, self.shard_group, opt.dim).to(g.dtype)
                del g
                chunks.append(i)
            elif n in self.tp_partial:
                partial.append(i)
            else:
                whole.append(i)
        self._sum_into(grads, whole, self.loss_group)
        self._sum_into(grads, partial, self.every_group)
        if len(self.dp_group) > 1:
            self._sum_into(grads, chunks, self.dp_group)

    # ---- the step -----------------------------------------------------------

    def _local(self, mb: dict[str, np.ndarray]
               ) -> tuple[dict[str, torch.Tensor], VisualShard | None]:
        """This rank's share of one microbatch on its device: its rows and
        sequence slice of the row fields, and its 1/W of the packed visual
        fields' packing axis (W = dp x fsdp x sp; whole, with no shard,
        when a field does not divide, as JAX then replicates it)."""
        B, T = mb["token_ids"].shape
        if B % self.data_width:
            raise ValueError(
                f"{B} rows do not divide over the data width dp x fsdp = "
                f"{self.data_width}")
        sp = len(self.sp_group)
        if T % sp:
            raise ValueError(f"sequence length {T} does not divide over "
                             f"sp={sp}")
        rb, tl = B // self.data_width, T // sp
        rows = slice(self.data_index * rb, (self.data_index + 1) * rb)
        cols = slice(self.coords["sp"] * tl, (self.coords["sp"] + 1) * tl)
        W = len(self.loss_group)
        i = self.loss_group.index(self.world.rank)
        split = W > 1 and all(mb[k].shape[0] % W == 0
                              for k in sharding.VISUAL_BATCH_FIELDS)

        def put(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

        out = {}
        for k, x in mb.items():
            if k in ROW_FIELDS:
                x = x[rows, cols]
            elif split and k in sharding.VISUAL_BATCH_FIELDS:
                n = x.shape[0] // W
                x = x[i * n:(i + 1) * n]
            out[k] = put(x)
        shard = None
        if split:
            shard = VisualShard(self.world, self.loss_group,
                                put(mb["segment_ids"]), put(mb["region_ids"]))
        return out, shard

    def _ring(self, mb: dict[str, np.ndarray]):
        from oryx_tpu_torch.ops.ring_attention import Ring, live_table

        if not self.cfg.attn_impl.startswith("ring"):
            return None
        rb = mb["token_ids"].shape[0] // self.data_width
        pos = mb["positions"][self.data_index * rb:
                              (self.data_index + 1) * rb]
        sp = len(self.sp_group)
        return Ring(self.world if sp > 1 else None,
                    self.sp_group if sp > 1 else (0,),
                    live_table(pos, sp, self.coords["sp"]))

    def _loss(self, mb, shard, count, numerics):
        """This rank's CE sum over its tokens / the microbatch's count."""
        from oryx_tpu_torch.models import oryx
        from oryx_tpu_torch.train.loss import chunked_causal_lm_sums
        from oryx_tpu_torch.train.step import BATCH_FIELDS

        cfg = self.cfg
        params = self.state.params
        hidden = oryx.forward(
            params, cfg,
            **{k: mb[k] for k in BATCH_FIELDS if k != "labels" and k in mb},
            remat=cfg.train.remat_policy if cfg.train.remat else "none",
            compute_dtype=self.dtype, return_hidden=True,
            visual_shard=shard)
        self.vit_rows = int(mb["patches"].shape[0])
        llm = params.llm
        w = (llm.embed.weight if cfg.llm.tie_word_embeddings
             else llm.lm_head.weight)
        tot, _, _ = chunked_causal_lm_sums(hidden, w, mb["labels"],
                                           chunk=cfg.train.loss_chunk)
        act = None
        if numerics:
            from oryx_tpu_torch.utils import numerics as numerics_lib

            act = numerics_lib.tree_absmax(hidden)
        return tot / max(count, 1), act

    def step(self, batch: dict[str, np.ndarray], numerics: bool = False):
        """One optimizer step over the [accum, ...] host batch (every
        field whole; this rank takes its share). Returns (metrics as
        device tensors, the same on every rank; CUDA events "start",
        "grads", "update" or {})."""
        from oryx_tpu_torch.constants import IGNORE_INDEX
        from oryx_tpu_torch.train.step import (
            TrainState, _layer_grads, compute_params)
        from oryx_tpu_torch.utils import numerics as numerics_lib

        cfg, params = self.cfg, self.state.params
        cuda = self.device.type == "cuda"
        marks = {}

        def mark(name):
            if cuda:
                marks[name] = torch.cuda.Event(enable_timing=True)
                marks[name].record()

        mark("start")
        leaves = [p for _, p in params.named_parameters()]
        accum = batch["token_ids"].shape[0]
        grads = None
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        ntok = 0
        acts = []
        with compute_params(params, self.dtype):
            for i in range(accum):
                host = {k: v[i] for k, v in batch.items()}
                count = int((host["labels"] != IGNORE_INDEX).sum())
                params.llm.ring = self._ring(host)
                try:
                    loss, act = self._loss(*self._local(host), count,
                                           numerics)
                    g = torch.autograd.grad(loss, leaves, allow_unused=True)
                finally:
                    params.llm.ring = None
                g = [torch.zeros_like(p) if x is None else x
                     for p, x in zip(leaves, g)]
                if accum == 1:
                    grads = g
                elif grads is None:
                    grads = [x.float() for x in g]
                else:
                    for acc, x in zip(grads, g):
                        acc += x.float()
                del g
                loss_sum = loss_sum + loss.detach()
                ntok += count
                if act is not None:
                    acts.append(act)
        if accum > 1:
            for k, x in enumerate(grads):
                grads[k] = x / accum
        mark("grads")
        self.reduce(grads)
        self.grad_bytes = sum(g.numel() * g.element_size() for g in grads)
        loss = self.world.sum(loss_sum / accum, self.loss_group)
        by_name = dict(zip(self.names, grads))
        gnorm = self.global_norm(by_name)
        metrics = {"loss": loss, "grad_norm": gnorm,
                   "num_tokens": torch.tensor(ntok, dtype=torch.int32)}
        if numerics:
            world, every = self.world, self.loss_group
            metrics["act_absmax"] = world.sum(torch.stack(acts).amax(),
                                              every, op="max")
            metrics["grad_absmax"] = world.sum(
                numerics_lib.tree_absmax(grads), every, op="max")
            metrics["param_absmax"] = world.sum(
                numerics_lib.tree_absmax(params), every, op="max")
            metrics["grad_layer_absmax"] = world.sum(
                numerics_lib.layer_absmax(_layer_grads(
                    self.names, grads, cfg.llm.num_layers)), every, op="max")
        del grads  # by_name holds them; each goes once its leaf is updated
        ok = True
        if cfg.train.skip_nonfinite_steps:
            ok = bool(torch.isfinite(loss) & torch.isfinite(gnorm))
            metrics["skipped"] = torch.tensor(int(not ok), dtype=torch.int32)
        opt_state = self.state.opt_state
        if ok:
            current = dict(params.named_parameters())
            views = {n: self._opt_view(n, p) for n, p in current.items()}

            def after(n):  # zero2: the owner's chunk, then every rank's
                by_name.pop(n)
                if views[n] is not current[n]:
                    current[n].copy_(self.world.all_gather(
                        views[n], self.shard_group, self.opt_place[n].dim))

            # In place, a leaf at a time: at full width a second copy of
            # the moments would not fit beside them.
            self.tx.update_(by_name, opt_state, views, after)
        mark("update")
        self.state = TrainState(self.state.step + 1, params, opt_state)
        return metrics, marks

    def _opt_view(self, name: str, p: torch.Tensor) -> torch.Tensor:
        """The parameter as the optimizer sees it: the rank's chunk under
        zero2's sharded moments, else the parameter itself."""
        if self.opt_place[name].split and not self.param_place[name].split:
            return self.opt_place[name].chunk(p)
        return p

    # ---- reports and checkpoints ---------------------------------------------

    def full_params(self) -> dict[str, torch.Tensor]:
        """Every leaf whole (CPU tensors), gathered over the shards."""
        out = {}
        for n, p in self.state.params.named_parameters():
            place = self.param_place[n]
            t = p.detach()
            if place.split:
                t = self.world.all_gather(t, self.shard_group, place.dim)
            if place.tp is not None:
                t = self.world.all_gather(t, self.tp_group, place.tp[0])
            out[n] = t.cpu()
        return out

    def report(self) -> dict:
        """This rank's holdings: the shapes of its parameters and moments,
        their bytes, the last step's gradient bytes, the packed visual rows
        its ViT last ran on, and its kernel launch counts (summed, and by
        launch key)."""
        from oryx_tpu_torch.ops.cuda import flash_attention as fa

        params = dict(self.state.params.named_parameters())
        opt = self.state.opt_state
        return {
            "rank": self.world.rank,
            "param_shapes": {n: tuple(p.shape) for n, p in params.items()},
            "mu_shapes": {n: tuple(t.shape) for n, t in opt["mu"].items()},
            "param_bytes": sum(p.numel() * p.element_size()
                               for p in params.values()),
            "moment_bytes": sum(t.numel() * t.element_size()
                                for part in ("mu", "nu")
                                for t in opt[part].values()),
            "grad_bytes": self.grad_bytes,
            "vit_rows": self.vit_rows,
            "launches": {
                "flash_fwd_lse": sum(fa.LAUNCHES_LSE.values()),
                "flash_bwd_dq": sum(fa.LAUNCHES_DQ.values()),
                "flash_bwd_dkv": sum(fa.LAUNCHES_DKV.values()),
            },
            "launch_keys": {
                "flash_fwd_lse": dict(fa.LAUNCHES_LSE),
                "flash_bwd_dq": dict(fa.LAUNCHES_DQ),
                "flash_bwd_dkv": dict(fa.LAUNCHES_DKV),
            },
            "collectives": {k: dict(v)
                            for k, v in tp_lib.COLLECTIVES.items()},
        }

    def manager(self, directory: str):
        from oryx_tpu_torch.utils.checkpoint import CheckpointManager

        if self.ckpt is None or self.ckpt.directory != os.path.abspath(
                rank_dir(directory, self.world.rank, self.world.size)):
            self.ckpt = CheckpointManager(
                rank_dir(directory, self.world.rank, self.world.size))
        return self.ckpt


def _tp_partial(names, places) -> set[str]:
    """The LoRA leaves whose gradient a tp rank holds partial (a column
    layer's A, B and scale, a row layer's A; the layer's kind by its
    weight's tp cut: output columns, dim 0, or input rows, dim 1)."""
    out = set()
    for name in names:
        owner, _, leaf = name.rpartition(".")
        weight = places.get(f"{owner}.weight")
        cut = None if weight is None else weight.tp
        if leaf in LORA_LEAVES and cut is not None and (
                cut[0] == 0 or leaf == "lora_a"):
            out.add(name)
    return out


class _Shape:
    """A mesh's axes (what the placement rules read)."""

    mesh_dim_names = sharding.AXES

    def __init__(self, shape):
        self.shape = tuple(shape)


def rank_dir(directory: str, rank: int, size: int) -> str:
    """Rank `rank`'s checkpoint directory of a run over `size` ranks."""
    return os.path.join(directory, f"rank{rank}of{size}")


def gather_objects(world, obj) -> list:
    """Every rank's `obj`, by rank (inside a dispatch)."""
    out = [None] * world.size
    dist.all_gather_object(out, obj, group=world.ctl_timed)
    return out


# ---- dispatched functions (each rank runs them on its own RankTrainer) -------


def start(cfg, source, mode, mesh_shape) -> RankTrainer:
    with torch.inference_mode(False):
        return RankTrainer(cfg, source, mode, mesh_shape)


def rank_step(rt: RankTrainer, batch, numerics: bool = False):
    with torch.inference_mode(False), torch.enable_grad():
        return rt.step(batch, numerics)


def rank_full_params(rt: RankTrainer) -> dict[str, torch.Tensor]:
    with torch.inference_mode(False):
        return rt.full_params()


def rank_reports(rt: RankTrainer) -> list[dict]:
    return gather_objects(rt.world, rt.report())


def rank_save(rt: RankTrainer, directory: str, step: int, force: bool
              ) -> bool:
    return rt.manager(directory).save(step, rt.state, rt.tx.trainable(),
                                      force=force)


def rank_restore(rt: RankTrainer, directory: str) -> int:
    with torch.inference_mode(False):
        rt.state = rt.manager(directory).restore(rt.state)
    return rt.state.step
