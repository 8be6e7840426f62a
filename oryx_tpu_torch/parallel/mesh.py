"""Device meshes over ranks (port of `oryx_tpu.parallel.mesh`).

JAX's mesh is an array of the devices one controller drives. The port's is
a `torch.distributed.device_mesh.DeviceMesh` over RANKS, one process each
(parallel/tp.py): rank r drives `devices[r]`, by default cuda:(r %
device_count), or the CPU when asked for. The first mesh a process
builds starts its ranks on this host; later meshes are laid over the
same ranks.

  dp    pure data parallelism (replicated params)
  fsdp  ZeRO-3 parameter sharding (parallel/zero.py; in serving, each
        layer's weights gathered as it runs)
  tp    tensor parallelism: attention heads, MLP columns, KV-pool heads
  sp    sequence parallelism (ring attention, ops/ring_attention.py)
"""

from __future__ import annotations

from datetime import timedelta

import torch
import torch.distributed as dist

from oryx_tpu_torch.config import MeshConfig
from oryx_tpu_torch.parallel import tp as tp_lib

AXES = ("dp", "fsdp", "tp", "sp")

def _shape(cfg: MeshConfig) -> tuple[int, int, int, int]:
    return (cfg.dp, cfg.fsdp, cfg.tp, cfg.sp)


def _device_mesh(shape: tuple[int, ...], device_type: str):
    """The DeviceMesh of `shape` over every rank (collective: every rank
    builds it, in the same order)."""
    from torch.distributed.device_mesh import DeviceMesh

    ranks = torch.arange(dist.get_world_size()).reshape(shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=AXES)


def build_mesh(cfg: MeshConfig, devices=None, *, device=None):
    """Mesh of `cfg`'s axis sizes over one rank per device. devices: one
    torch device per rank (default: the running world's, else
    `tp.default_devices` of `device`, "cuda" when None: cuda:(r %
    device_count), raising without a card). A running world on another
    device type than `device` raises. The sizes must multiply to the
    device count; size-1 axes are kept. Without a running world this
    starts one of len(devices) ranks."""
    world = tp_lib.current()
    if devices is None and world is not None:
        devices = world.devices
        if device is not None and (
                torch.device(device).type != world.device.type):
            raise ValueError(
                f"this process's ranks run on {world.device.type}, not "
                f"{device}")
    elif devices is None:
        devices = tp_lib.default_devices(cfg.num_devices, device or "cuda")
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if cfg.num_devices != n:
        raise ValueError(
            f"mesh {cfg.dp}x{cfg.fsdp}x{cfg.tp}x{cfg.sp}="
            f"{cfg.num_devices} != {n} devices"
        )
    if world is None:
        world = tp_lib.start(n, devices)
    elif devices != list(world.devices):
        raise ValueError(
            f"this process's ranks drive {world.devices}, not {devices}")
    return world.call(_device_mesh, _shape(cfg), devices[0].type, bind=True)


def build_hybrid_mesh(cfg: MeshConfig, *, num_slices: int):
    """Multi-slice mesh: dp spans slices, fsdp/tp/sp stay inside one.
    Requires cfg.dp % num_slices == 0. The ranks of this host are one
    slice-major layout, as JAX's CPU branch is: `build_mesh`."""
    if cfg.dp % num_slices != 0:
        raise ValueError(f"dp={cfg.dp} not divisible by {num_slices} slices")
    return build_mesh(cfg)


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a mesh (JAX's `dict(mesh.shape)`)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def parse_shard_arg(arg: str | None, *, device=None):
    """CLI `--shard MODE=N` (e.g. "tp=8") -> (mesh, mode); (None, "tp")
    when arg is None. Shared by the serve and eval entry points so the
    validation lives once. device: the entry point's `--device`, where
    the ranks run (`build_mesh`)."""
    if arg is None:
        return None, "tp"
    mode, sep, n = arg.partition("=")
    if mode not in ("tp", "fsdp") or not sep or not n.isdigit() or int(n) < 1:
        raise ValueError(
            f"--shard expects tp=N or fsdp=N with N >= 1, got {arg!r}"
        )
    return build_mesh(MeshConfig(**{mode: int(n)}), device=device), mode


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    backend: str,
    timeout: int = 300,
) -> None:
    """Multi-host rendezvous: `init_process_group` over
    tcp://coordinator_address with an explicit backend ("nccl" or "gloo")
    and this process's rank. timeout (seconds) covers slow peers."""
    if None in (coordinator_address, num_processes, process_id):
        raise ValueError(
            "initialize_distributed needs coordinator_address, "
            "num_processes and process_id: nothing on the host names them")
    dist.init_process_group(
        backend=backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=timedelta(seconds=timeout),
    )


def process_batch_slice(global_batch: int) -> tuple[int, int]:
    """(start, size) of this process's slice of the global batch."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    r = dist.get_rank() if dist.is_initialized() else 0
    if global_batch % n != 0:
        raise ValueError(f"global batch {global_batch} % {n} processes != 0")
    per = global_batch // n
    return r * per, per
