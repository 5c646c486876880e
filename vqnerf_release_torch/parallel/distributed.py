"""A process group for geometry extraction over several processes or
hosts (counterpart of vqnerf_release_tpu/parallel/distributed.py).

The reference shards the long light-visibility extraction by launching N
independent processes with ``--num_p N --p_i i``. Here the processes join a
``torch.distributed`` group on the gloo backend: each takes the view shard
of its rank and extracts it on its own devices. Extraction needs no
collective (params are replicated and views are independent), so the group
only numbers the processes; gloo also lets several ranks share one card,
which NCCL refuses.

Composition rule (all optional, all composable):
  * ``--num-hosts/--host-id/--coordinator`` (or torchrun's RANK,
    WORLD_SIZE and MASTER_ADDR): views split across the processes;
  * ``--num-p/--p-i`` on top subdivides each process's shard further,
    giving num_p * world_size slots;
  * ``--devices`` splits each view's rays over the process's local
    devices.
"""

import os

import torch

__all__ = ["init_distributed", "shutdown_distributed", "compose_view_shard",
           "local_mesh"]


def init_distributed(coordinator=None, num_hosts=None, host_id=None):
    """Join (or skip) the process group; returns (rank, world_size).

    One host (no coordinator, num_hosts absent or <= 1, and no torchrun
    environment): a no-op that returns (0, 1). With a coordinator
    ("host:port", the rank-0 process's address), num_hosts and host_id
    give the world size and this process's rank. Without flags, torchrun's
    RANK, WORLD_SIZE and MASTER_ADDR/MASTER_PORT are read, as JAX detects
    a pod's hosts."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    env = os.environ
    multi = bool(coordinator) or (num_hosts is not None and num_hosts > 1)
    if not multi:
        if int(env.get("WORLD_SIZE", "1")) > 1 and "RANK" in env \
                and "MASTER_ADDR" in env:
            dist.init_process_group("gloo", init_method="env://")
            return dist.get_rank(), dist.get_world_size()
        return 0, 1
    if num_hosts is None:
        num_hosts = int(env.get("WORLD_SIZE", "0")) or None
    if host_id is None and "RANK" in env:
        host_id = int(env["RANK"])
    if num_hosts is None or host_id is None:
        raise ValueError(
            "a process group needs its size and this process's rank: give "
            "--num-hosts and --host-id (or set WORLD_SIZE and RANK)")
    if not 0 <= host_id < num_hosts:
        raise ValueError(f"--host-id {host_id} outside 0..{num_hosts - 1}")
    init_method = ("tcp://" + coordinator if coordinator
                   else "env://")  # MASTER_ADDR / MASTER_PORT
    # every rank on this host: gloo's pairs on the loopback too, not on
    # the address the host name resolves to. gloo reads the variable when
    # the group is made, so it is set for that call alone.
    loopback = bool(coordinator) and "GLOO_SOCKET_IFNAME" not in env and \
        coordinator.rsplit(":", 1)[0] in ("127.0.0.1", "localhost")
    if loopback:
        env["GLOO_SOCKET_IFNAME"] = "lo"
    try:
        dist.init_process_group("gloo", init_method=init_method,
                                world_size=num_hosts, rank=host_id)
    finally:
        if loopback:
            del env["GLOO_SOCKET_IFNAME"]
    return dist.get_rank(), dist.get_world_size()


def shutdown_distributed():
    """Leave the process group, if this process joined one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def compose_view_shard(num_p, p_i, process_index, process_count):
    """Fold the host grid into the reference's --num_p/--p_i view split.

    Returns (total_shards, shard_index) such that every (host, local
    process) pair owns a distinct slot and the union covers all views —
    the same contiguous-range math as gen_geo.py:141-146, applied to
    num_p * process_count slots. With no local split (num_p None) the
    hosts alone form the grid; with one host it degrades to the
    reference behavior exactly.
    """
    if process_count <= 1:
        return num_p, p_i
    if num_p is None:
        return process_count, process_index
    if p_i is None:
        raise ValueError("--num-p given without --p-i")
    return num_p * process_count, p_i * process_count + process_index


def local_mesh(devices_arg="all", device="cuda"):
    """The mesh over this process's local devices of ``device``'s type
    (never more than the host has): ``devices_arg`` is 'all' or a count;
    None, 1 or a single local device give None (no mesh). A count that is
    not an integer, or more devices than are visible, raise ValueError
    with the JAX command's message."""
    from ..utils.device import resolve_device
    from .mesh import get_mesh

    if devices_arg in (None, "", "1", 1):
        return None
    kind = resolve_device(device).type
    avail = get_mesh(None, kind)
    if devices_arg == "all":
        n = len(avail)
    else:
        try:
            n = int(devices_arg)
        except ValueError:
            raise ValueError(f"--devices must be 'all' or an integer, got "
                             f"{devices_arg!r}") from None
    if n <= 1:
        return None
    if n > len(avail):
        raise ValueError(
            f"--devices {n} but only {len(avail)} {kind} devices visible")
    return avail[:n]
