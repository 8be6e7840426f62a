"""Parameter and KV-pool sharding rules, the serving half (port of
`oryx_tpu.parallel.sharding`).

JAX declares a placement per leaf and GSPMD partitions the program. Here
each rank HOLDS its slice: `param_specs` gives every parameter of the
port's model (state-dict names, linear weights [out, in]) the mesh axis of
each dim, from JAX's path rules applied through the name map of
models/convert.py (a layer-stacked JAX leaf loses its leading "layer"
axis; a linear kernel [in, out] is reversed), and `shard_params` cuts a
rank's slices out of a whole model, a state dict (a memory-mapped
checkpoint) or the seeded init, one tensor at a time.

Serving splits over tp only ("zero2" rules): q/k/v, gate/up, ViT fc1 and
projector fc1 by output columns (their biases with them); o_proj,
down_proj, ViT o_proj and fc2 and projector fc2 by input rows, each
followed by one all_reduce(SUM) in the model, a row-parallel bias added
once after it. Embeddings, norms, the LM head and the compressor's
attention stay whole. Two places differ from JAX's table as it resolves:
JAX's `vit/layers/?_proj` patterns also match `o_proj` and shadow its own
o_proj rules; the port applies the o_proj rules as written (split by
input rows: a column-split o_proj would need an all-gather). And JAX's
projector fc1 bias is declared whole, which GSPMD reconciles with its
column-split kernel; a rank here keeps the bias slice of its columns.

Training splits over the combined ("fsdp", "sp") width as well
(`param_shardings(mode="fsdp")`, the ZeRO stages of parallel/zero.py): a
leaf's `embed` dim is cut in contiguous chunks, one a rank of its
(fsdp, sp) group; a leaf with no embed axis, or whose embed width does not
divide, stays whole (JAX's GSPMD pads such a dim; the port keeps it
whole). Every mode cuts heads and MLP columns over tp, so under fsdp x tp
a leaf with both axes is cut on both (`Placement.tp` beside its (fsdp,
sp) cut). `opt_state_specs`, `batch_spec`, `batch_field_spec` and
`cast_params_for_compute` give JAX's specs and casts leaf by leaf.

`constrain`, `ambient_mesh` and `mesh_scope` annotate a GSPMD program and
have no counterpart here (nothing partitions a torch program).
"""

from __future__ import annotations

import dataclasses
import fnmatch
import re
from typing import Any

import torch
from torch import nn

from oryx_tpu_torch.config import OryxConfig
from oryx_tpu_torch.parallel.mesh import AXES, axis_sizes

# JAX path pattern -> logical axes of the JAX leaf (fnmatch on
# "/"-joined JAX paths; first match wins). JAX's table, with the ViT
# o_proj rules ahead of the `?_proj` patterns that shadow them in JAX.
LOGICAL_RULES: tuple[tuple[str, tuple[str | None, ...]], ...] = (
    ("llm/embed/weight", ("vocab", "embed")),
    ("llm/layers/*_norm/weight", ("layer", None)),
    ("llm/layers/q_proj/kernel", ("layer", "embed", "heads")),
    ("llm/layers/k_proj/kernel", ("layer", "embed", "heads")),
    ("llm/layers/v_proj/kernel", ("layer", "embed", "heads")),
    ("llm/layers/o_proj/kernel", ("layer", "heads", "embed")),
    ("llm/layers/*_proj/bias", ("layer", "heads")),
    ("llm/layers/gate_proj/kernel", ("layer", "embed", "mlp")),
    ("llm/layers/up_proj/kernel", ("layer", "embed", "mlp")),
    ("llm/layers/down_proj/kernel", ("layer", "mlp", "embed")),
    ("llm/final_norm/weight", (None,)),
    ("llm/lm_head/kernel", ("embed", "vocab")),
    ("vit/patch_embed/kernel", (None, "embed")),
    ("vit/patch_embed/bias", ("embed",)),
    ("vit/pos_embed/weight", (None, None)),
    ("vit/layers/norm*/weight", ("layer", None)),
    ("vit/layers/norm*/bias", ("layer", None)),
    ("vit/layers/o_proj/kernel", ("layer", "heads", "embed")),
    ("vit/layers/o_proj/bias", ("layer", "embed")),
    ("vit/layers/?_proj/kernel", ("layer", "embed", "heads")),
    ("vit/layers/?_proj/bias", ("layer", "heads")),
    ("vit/layers/fc1/kernel", ("layer", "embed", "mlp")),
    ("vit/layers/fc1/bias", ("layer", "mlp")),
    ("vit/layers/fc2/kernel", ("layer", "mlp", "embed")),
    ("vit/layers/fc2/bias", ("layer", "embed")),
    ("vit/post_norm/*", (None,)),
    ("compressor/projector/fc1/kernel", ("embed", "mlp")),
    ("compressor/projector/fc2/kernel", ("mlp", "embed")),
    ("compressor/*/kernel", (None, None)),
    ("compressor/*/bias", (None,)),
    ("compressor/*/weight", (None,)),
)

def mesh_rules(mode: str) -> dict[str, Any]:
    """Logical axis -> mesh axis (or axes) for a sharding mode."""
    base = {"layer": None, "vocab": None, "heads": "tp", "mlp": "tp",
            "embed": None}
    if mode == "fsdp":
        base["embed"] = ("fsdp", "sp")
    elif mode not in ("zero2", "ddp"):
        raise ValueError(f"unknown sharding mode {mode!r}")
    return base


_LAYER = re.compile(r"\.layers\.\d+\.")


def jax_path(name: str, linear: bool) -> tuple[str, bool]:
    """(JAX tree path, layer-stacked?) of a port parameter name: the
    layer index folds into the stacked "layers" node and a linear
    layer's `weight` is JAX's `kernel`."""
    stacked = bool(_LAYER.search(name))
    path = _LAYER.sub(".layers.", name)
    owner, _, leaf = path.rpartition(".")
    if linear and leaf == "weight":
        leaf = "kernel"
    return f"{owner}.{leaf}".replace(".", "/"), stacked


def _linear_names(params: nn.Module) -> set[str]:
    return {f"{n}.weight" for n, m in params.named_modules()
            if isinstance(m, nn.Linear)}


def logical_axes(params: nn.Module) -> dict[str, tuple]:
    """{parameter name: logical axes in the port's layout}."""
    linear = _linear_names(params)
    out = {}
    for name, p in params.named_parameters():
        path, stacked = jax_path(name, name in linear)
        axes = next((a for pat, a in LOGICAL_RULES
                     if fnmatch.fnmatch(path, pat)), None)
        if axes is None:
            out[name] = (None,) * p.ndim
            continue
        if stacked:
            axes = axes[1:]
        if name in linear:
            axes = tuple(reversed(axes))
        if len(axes) != p.ndim:
            raise ValueError(f"rule for {path} has {len(axes)} axes but "
                             f"{name} is rank {p.ndim}")
        out[name] = axes
    return out


def param_specs(params: nn.Module, mode: str = "fsdp") -> dict[str, tuple]:
    """{parameter name: mesh axis (or None) of each dim}."""
    rules = mesh_rules(mode)
    return {name: tuple(None if a is None else rules.get(a) for a in axes)
            for name, axes in logical_axes(params).items()}


@dataclasses.dataclass(frozen=True)
class Placement:
    """One rank's slice of a parameter: `dim` split in `parts` contiguous
    chunks over the (fsdp, sp) width (None: whole), this rank's chunk
    `index`, the cut the ZeRO stages gather; and `tp` = (dim, parts,
    index), the cut over the tensor-parallel ranks (heads or MLP
    columns) a rank holds for good, or None. The two cuts are on
    different dims of the leaf."""
    dim: int | None
    parts: int
    index: int
    tp: tuple[int, int, int] | None = None

    @property
    def split(self) -> bool:
        return self.dim is not None and self.parts > 1

    def chunk(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's (fsdp, sp) chunk of `t`, a tensor that already
        holds this rank's tp slice."""
        return _narrow(t, self.dim, self.parts, self.index) if self.split \
            else t

    def take(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the whole leaf `t` (both cuts)."""
        if self.tp is not None:
            t = _narrow(t, *self.tp)
        return self.chunk(t)

    def tp_only(self) -> "Placement":
        """This placement without its (fsdp, sp) cut."""
        return Placement(None, 1, 0, self.tp)


def _narrow(t: torch.Tensor, dim: int, parts: int, index: int
            ) -> torch.Tensor:
    n = t.shape[dim]
    if n % parts:
        raise ValueError(f"dim {dim} of width {n} does not divide over "
                         f"{parts} ranks")
    w = n // parts
    return t.narrow(dim, index * w, w)


def mesh_coords(shape, rank: int) -> dict[str, int]:
    """{axis: this rank's index on it} of a rank of a (dp, fsdp, tp, sp)
    mesh laid out rank-major (`mesh.build_mesh`)."""
    return dict(zip(AXES, (int(i) for i in _unravel(rank, shape))))


def _unravel(rank: int, shape) -> tuple[int, ...]:
    out = []
    for n in reversed(tuple(shape)):
        out.append(rank % n)
        rank //= n
    return tuple(reversed(out))


def axis_group(shape, rank: int, axes) -> list[int]:
    """The ranks that share `rank`'s place on every mesh axis but `axes`
    (rank order): the group a collective over `axes` meets."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    mine = _unravel(rank, shape)
    total = 1
    for n in shape:
        total *= n
    return [r for r in range(total)
            if all(a == b or name in axes for name, a, b in
                   zip(AXES, _unravel(r, shape), mine))]


def _mesh_shape(mesh) -> tuple[int, int, int, int]:
    if mesh is None:
        return (1, 1, 1, 1)
    sizes = axis_sizes(mesh)
    return tuple(sizes.get(a, 1) for a in AXES)


def param_shardings(mesh, params: nn.Module, mode: str = "zero2",
                    rank: int | None = None) -> dict[str, Placement]:
    """{parameter name: this rank's Placement} on `mesh` (rank: this
    process's rank in the world by default). A dim is split over the
    product of its mesh axes' sizes, this rank's chunk its index in their
    group: the heads/mlp dim over tp (`Placement.tp`), the embed dim over
    (fsdp, sp) under the fsdp rules, both at once on a leaf that has both
    (JAX's `param_specs` in every mode). A bias follows its weight's
    split output columns (tp). An fsdp dim that does not divide stays
    whole."""
    specs = param_specs(params, mode)
    shape = _mesh_shape(mesh)
    sizes = dict(zip(AXES, shape))
    if rank is None:
        from oryx_tpu_torch.parallel import tp as tp_lib

        world = tp_lib.current()
        rank = world.rank if world is not None else 0
    shapes = dict((n, tuple(p.shape)) for n, p in params.named_parameters())
    tp_index = axis_group(shape, rank, "tp").index(rank)
    out = {}
    for name, spec in specs.items():
        zero, tp = (None, 1, 0), None
        for dim, axes in enumerate(spec):
            if axes is None:
                continue
            axes = (axes,) if isinstance(axes, str) else tuple(axes)
            parts = 1
            for a in axes:
                parts *= sizes[a]
            if parts == 1:
                continue
            if axes == ("tp",):
                tp = (dim, parts, tp_index)
            elif not shapes[name][dim] % parts:
                group = axis_group(shape, rank, axes)
                zero = (dim, parts, group.index(rank))
        if tp is None and name.endswith(".bias") and sizes["tp"] > 1:
            w = specs.get(name[: -len("bias")] + "weight")
            if w is not None and w and w[0] == "tp":
                tp = (0, sizes["tp"], tp_index)
        out[name] = Placement(*zero, tp)
    return out


def batch_spec() -> tuple:
    """Activations/batch rows shard over the full data-parallel width."""
    return (("dp", "fsdp"),)


# Packed visual buffer fields of the training batch (ops/packing +
# splice.query_slots layout): their second axis is the packing axis.
VISUAL_BATCH_FIELDS = (
    "patches", "segment_ids", "pos_coords", "region_ids", "q_region_ids",
)


def batch_field_spec(name: str) -> tuple:
    """JAX's placement of a [accum, ...] training batch field: packed
    visual buffers over (dp, fsdp, sp) on their packing axis, row fields
    over (dp, fsdp). The port's ranks take their rows of a row field (and,
    under sp, their slice of its sequence) and their 1/W of a visual
    field's packing axis (parallel/zero.RankTrainer._local)."""
    if name in VISUAL_BATCH_FIELDS:
        return (None, ("dp", "fsdp", "sp"))
    return (None, ("dp", "fsdp"))


def cast_params_for_compute(params, dtype: torch.dtype, mode: str = "fsdp"
                            ) -> dict[str, torch.Tensor]:
    """{name: the leaf in the compute dtype} (floating leaves not in
    `dtype` cast, the rest as they are). A ZeRO-3 rank casts ITS SHARD
    before the all-gather, so the gathers move compute-dtype bytes, the
    point of JAX's constrained cast; the cast's gradient arrives in the
    leaf's own dtype. `mode` names the placement, as in JAX, and changes
    no value."""
    mesh_rules(mode)
    items = (params.named_parameters() if isinstance(params, nn.Module)
             else params.items())
    return {n: (p.to(dtype) if p.is_floating_point() and p.dtype != dtype
                else p) for n, p in items}


def opt_state_specs(opt_state: dict, params: nn.Module, mode: str = "fsdp"
                    ) -> dict:
    """Specs of the optimizer state (train/optimizer.AdamW.init's tree):
    a moment inherits its parameter's spec under `mode`; the counts are
    replicated (()). For ZeRO-2 pass mode="fsdp" (sharded moments) with
    mode="zero2" for the params, as in JAX."""
    specs = param_specs(params, mode)
    shapes = {n: p.dim() for n, p in params.named_parameters()}

    def walk(tree, leaf_name=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if (isinstance(tree, torch.Tensor) and leaf_name in specs
                and tree.dim() == shapes[leaf_name]):
            return specs[leaf_name]
        return ()

    return walk(opt_state)


def check_divisible(cfg: OryxConfig, tp: int) -> None:
    """Every head count and split width must divide by tp."""
    widths = {
        "llm.num_heads": cfg.llm.num_heads,
        "llm.num_kv_heads": cfg.llm.num_kv_heads,
        "llm.intermediate_size": cfg.llm.intermediate_size,
        "llm.hidden_size (projector fc1 columns)": cfg.llm.hidden_size,
        "vision.num_heads": cfg.vision.num_heads,
        "vision.intermediate_size": cfg.vision.intermediate_size,
    }
    for what, n in widths.items():
        if n % tp:
            raise ValueError(f"{what} = {n} does not divide over tp={tp}")


def shard_params(source, shardings: dict[str, Placement], *,
                 device=None, dtype: torch.dtype | None = None
                 ) -> dict[str, torch.Tensor]:
    """A rank's slices {name: tensor} of `source` (a whole module, or a
    state dict such as a memory-mapped checkpoint), each cut and moved to
    `device` (cast to `dtype` when floating) before the next is read."""
    state = source.state_dict() if isinstance(source, nn.Module) else source
    out = {}
    for name, place in shardings.items():
        t = place.take(state[name])
        if dtype is not None and t.is_floating_point():
            t = t.to(device, dtype)
        elif device is not None:
            t = t.to(device)
        out[name] = t.contiguous()
    return out


def seeded_shard(cfg: OryxConfig, shardings: dict[str, Placement], seed: int,
                 *, device, dtype: torch.dtype) -> dict[str, torch.Tensor]:
    """A rank's slices of `oryx.init_params(cfg, Generator(device).
    manual_seed(seed), dtype=dtype)`: the same draws in the same order
    (models/params.init_draws), each tensor drawn whole, cut, and freed
    before the next."""
    from oryx_tpu_torch.models.oryx import empty_model
    from oryx_tpu_torch.models.params import init_draws

    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for path, leaf, full in init_draws(empty_model(cfg, dtype), device, g):
        name = f"{path}.{leaf}" if path else leaf
        out[name] = shardings[name].take(full).to(dtype).contiguous()
    return out


def local_model(cfg: OryxConfig, state: dict[str, torch.Tensor], world
                ) -> nn.Module:
    """The rank's OryxModel over its slices (frozen), each of its three
    parts carrying `tp` = the world its row-parallel products reduce
    over."""
    model = frozen_model(cfg, state)
    for part in (model.llm, model.vit, model.compressor):
        part.tp = world
    return model


def frozen_model(cfg: OryxConfig, state: dict[str, torch.Tensor]
                 ) -> nn.Module:
    """An OryxModel over the tensors of `state` ({name: tensor}, LoRA
    leaves included), each a frozen parameter as it is."""
    from oryx_tpu_torch.models.oryx import empty_model

    model = empty_model(cfg)
    for name, t in state.items():
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner)
        mod._parameters[leaf] = nn.Parameter(t, requires_grad=False)
    return model


_LAYER_LEAF = re.compile(r"^(llm|vit)\.layers\.\d+\.")


def serving_shardings(mesh, params: nn.Module, mode: str,
                      rank: int | None = None) -> dict[str, Placement]:
    """A serving rank's placements. "tp": `param_shardings` under the
    zero2 rules (heads and MLP columns over tp). "fsdp": the fsdp rules
    for the decoder's and the ViT's layer leaves, each gathered as its
    layer runs (parallel/zero.serving_gatherer); the embedding, the head,
    the final norms and the compressor stay whole on every rank (JAX
    shards them too and gathers them at use: the port keeps the one
    weight a decode step reads outside the layers resident)."""
    if mode == "tp":
        return param_shardings(mesh, params, "zero2", rank)
    if mode != "fsdp":
        raise ValueError(f"unknown serving sharding mode {mode!r}: tp|fsdp")
    places = param_shardings(mesh, params, "fsdp", rank)
    return {n: p if _LAYER_LEAF.match(n) else Placement(None, 1, 0)
            for n, p in places.items()}


@dataclasses.dataclass(frozen=True)
class SeededParams:
    """Weights every rank of a tensor-parallel pipeline draws from a seed:
    the shards of `oryx.init_params(cfg, Generator(device).manual_seed(
    seed), dtype=dtype)`, each rank drawing tensor by tensor and keeping
    its slice (no rank holds the whole tree)."""

    seed: int = 0
    dtype: torch.dtype = torch.float32


@dataclasses.dataclass(frozen=True)
class CheckpointParams:
    """Weights every rank of a tensor-parallel pipeline reads from a
    `save_pretrained` directory: each rank cuts its slices off the
    memory-mapped safetensors, cast to `dtype` on its device."""

    path: str
    dtype: torch.dtype = torch.float32


def rank_params(params, cfg: OryxConfig, mesh, device, mode: str = "tp"
                ) -> nn.Module:
    """This rank's shard of `params` (a whole OryxModel, a state dict,
    SeededParams or CheckpointParams; LoRA adapters, when the weights
    carry them, whole on every rank) on `device`: under "tp" its three
    parts carrying the world (`local_model`), under "fsdp" its layers
    gathering their leaves as they run (`serving_shardings`)."""
    from oryx_tpu_torch.models.oryx import empty_model
    from oryx_tpu_torch.models.qwen2 import lora_shells
    from oryx_tpu_torch.parallel import tp as tp_lib

    world = tp_lib.current()
    source = params
    if isinstance(params, CheckpointParams):
        from oryx_tpu_torch.utils import safetensors as st

        source = st.load_safetensors_dir(params.path)
    elif isinstance(params, nn.Module):
        source = params.state_dict()
    # The placements cover the source's LoRA leaves too (whole).
    shape = empty_model(cfg)
    if not isinstance(params, SeededParams):
        lora_shells(shape, source)
    shardings = serving_shardings(mesh, shape, mode, rank=world.rank)
    if isinstance(params, SeededParams):
        state = seeded_shard(cfg, shardings, params.seed, device=device,
                             dtype=params.dtype)
    else:
        state = shard_params(source, shardings, device=device,
                             dtype=getattr(params, "dtype", None))
    if mode == "tp":
        return local_model(cfg, state, world)
    from oryx_tpu_torch.parallel import zero

    model = frozen_model(cfg, state)
    zero.serving_gatherer(model, shardings, world, _mesh_shape(mesh))
    return model


def paged_kv_spec(mesh) -> tuple | None:
    """Axes of a paged KV pool leaf [layers, pages, page_size, kv_heads,
    head_dim] on `mesh`: kv heads over tp, or None (whole) without a tp
    axis wider than 1. Pages never split: block tables index them
    globally."""
    if mesh is None or "tp" not in (mesh.mesh_dim_names or ()):
        return None
    if axis_sizes(mesh)["tp"] <= 1:
        return None
    return (None, None, None, "tp", None)


def shard_paged_kv(kv_pages: dict, mesh, *, num_kv_heads: int | None = None,
                   rank: int | None = None) -> dict:
    """A rank's heads of a whole paged pool ({"k", "v"} planes of
    `qwen2.init_paged_kv_cache`), in planes of its own with the sink page
    behind them; a quantized plane's per-row scales have no head axis and
    are copied whole. JAX replicates a pool whose heads do not divide; the
    port refuses (a rank holds its heads' pages and nothing else)."""
    from oryx_tpu_torch.ops import paged_kv

    spec = paged_kv_spec(mesh)
    if spec is None:
        return kv_pages
    tp = axis_sizes(mesh)["tp"]
    if rank is None:
        from oryx_tpu_torch.parallel import tp as tp_lib

        rank = tp_lib.current().rank
    L, P, ps, heads, D = kv_pages["k"].shape
    if (num_kv_heads or heads) % tp:
        raise ValueError(
            f"{num_kv_heads or heads} KV heads do not divide over tp={tp}")
    place = Placement(3, tp, rank)

    def cut(plane):
        if isinstance(plane, paged_kv.QuantPages):
            fmt = ("int8" if plane.q.dtype == torch.int8 else "fp8_e4m3")
            out = paged_kv.init_quant_pages(
                L, P, ps, heads // tp, D, fmt=fmt,
                dequant_dtype=plane.dequant_dtype, device=plane.q.device)
            out.q.copy_(place.take(plane.q))
            out.scale.copy_(plane.scale)
            return out
        out = paged_kv.init_paged_pool(L, P, ps, heads // tp, D,
                                       dtype=plane.dtype,
                                       device=plane.device)
        out.copy_(place.take(plane))
        return out

    return {name: cut(plane) for name, plane in kv_pages.items()}
