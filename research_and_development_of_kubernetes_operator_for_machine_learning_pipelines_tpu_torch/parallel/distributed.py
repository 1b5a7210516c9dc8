"""Process-group initialization for a replica of several ranks (port of the
JAX package's ``parallel/distributed.py``).

A replica whose ``meshShape`` spans N ranks runs N processes that must form
one ``torch.distributed`` group before any collective.  The operator's
manifests give each pod ``JAX_COORDINATOR_ADDRESS`` (``host:port`` of rank
0), ``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID``; here they become a TCP
``init_method``, a world size and a rank.  A single process is a no-op, so
the same server code runs everywhere.

The backend is chosen in one place, :func:`choose_backend`: ``nccl`` where
no two ranks share a CUDA device (the ranks on this host,
``LOCAL_WORLD_SIZE``, fit its ``device_count``), ``gloo`` where ranks share
one card (a machine with one GPU: NCCL refuses two ranks on one device)
and on the CPU.  A unit that spans hosts sets ``LOCAL_WORLD_SIZE`` and
``LOCAL_RANK`` in each process (unset, every rank is on one host); hosts
of one unit have the same cards, so every rank makes the same choice.
Gloo moves no tensor off the card: the model's tensors stay on ``cuda:0``
and the collectives that ProcessGroupGloo runs only on host tensors are
staged explicitly in ``parallel/collectives.py``.

Besides the default group, every rank makes one more group over the whole
world, always gloo: the control channel of ``server/multihost.py``, which
carries host bytes whatever the model's collectives run on.  A follower
waits in that channel's broadcast for as long as the leader has no work,
so its timeout is :data:`CONTROL_TIMEOUT` (365 days), which an idle replica
cannot reach; the model groups keep the default timeout (or the caller's
``timeout``), so a wedged collective still fails.
"""

from __future__ import annotations

import datetime
import logging
import os

_log = logging.getLogger("tpumlops_torch.distributed")

# The control group's timeout: an idle replica's followers wait in its
# broadcast between requests, for as long as no request comes.
CONTROL_TIMEOUT = datetime.timedelta(days=365)

_initialized = False
_control_group = None


def local_world_size(world: int) -> int:
    """The ranks on this host: ``LOCAL_WORLD_SIZE``, else the whole world
    (every rank on one host)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", world))


def local_rank(rank: int, world: int) -> int:
    """This rank's index on its host: ``LOCAL_RANK``, else the rank within
    its host's block of ``LOCAL_WORLD_SIZE`` consecutive ranks."""
    return int(os.environ.get("LOCAL_RANK", int(rank) % local_world_size(world)))


def choose_backend(local_world: int, device_type: str) -> str:
    """``nccl`` where no two of this host's ``local_world`` ranks share a
    CUDA device, else ``gloo`` (ranks sharing one card, or CPU ranks)."""
    if device_type == "cuda":
        import torch

        if torch.cuda.is_available() and int(local_world) <= torch.cuda.device_count():
            return "nccl"
    return "gloo"


def rank_device(device_type: str, local_rank: int):
    """The device a rank runs on: ``cuda:(local_rank % device_count)`` (with
    one card every rank takes ``cuda:0``), or the CPU when asked for."""
    import torch

    if device_type != "cuda":
        return torch.device(device_type)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass --device cpu to run on the CPU")
    return torch.device(f"cuda:{int(local_rank) % torch.cuda.device_count()}")


def configure_cpu_rehearsal(num_local_devices: int = 1) -> None:
    """The reference's entry for rehearsing a replica of several ranks on
    CPU processes.  Here one process is one rank (one device) and a CPU
    rank already takes gloo (:func:`choose_backend`), so this only checks
    ``num_local_devices`` is 1: the reference's several virtual devices a
    process are a JAX notion."""
    if int(num_local_devices) != 1:
        raise ValueError(
            f"one process drives one rank here; num_local_devices={num_local_devices}"
        )


def maybe_initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    device_type: str | None = None,
    timeout: datetime.timedelta | None = None,
) -> bool:
    """Initialize the process group if (and only if) a world of several
    ranks is configured.

    Resolution order: explicit arguments, then the environment
    (``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
    ``JAX_PROCESS_ID``).  ``device_type`` (``cuda`` where a card is seen,
    unless given) feeds :func:`choose_backend`; ``timeout`` bounds
    the model groups' collectives (the default group's default when None).
    Returns True when the group is (already) initialized."""
    global _initialized, _control_group
    if _initialized:
        return True
    coordinator_address = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    env_np = os.environ.get("JAX_NUM_PROCESSES")
    env_pid = os.environ.get("JAX_PROCESS_ID")
    if num_processes is None and env_np is not None:
        num_processes = int(env_np)
    if process_id is None and env_pid is not None:
        process_id = int(env_pid)
    if not coordinator_address or not num_processes or num_processes <= 1:
        _log.debug("single process (no coordinator configured)")
        return False
    if process_id is None:
        raise ValueError("a world of several ranks needs this process's rank (JAX_PROCESS_ID)")
    import torch.distributed as dist

    if device_type is None:
        import torch

        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    backend = choose_backend(local_world_size(num_processes), device_type)
    kw = {} if timeout is None else {"timeout": timeout}
    addr = coordinator_address
    init_method = addr if "://" in addr else f"tcp://{addr}"
    dist.init_process_group(backend, init_method=init_method, world_size=int(num_processes),
                            rank=int(process_id), **kw)
    # Every rank enters new_group, in the same order.
    _control_group = dist.new_group(backend="gloo", timeout=CONTROL_TIMEOUT)
    _initialized = True
    _log.info(
        "torch.distributed initialized: %d ranks, this is rank %d; backend %s "
        "(device %s); control channel gloo, timeout %s",
        num_processes, process_id, backend, device_type, CONTROL_TIMEOUT,
    )
    return True


def control_group():
    """The world-wide gloo group of the control channel (None before
    :func:`maybe_initialize_distributed` formed a world)."""
    return _control_group


def backend_name() -> str | None:
    """The default group's backend, None without a group."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return None
    return str(dist.get_backend())


def shutdown_distributed() -> None:
    """Destroy the process group (and the control group with it)."""
    global _initialized, _control_group
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _initialized = False
    _control_group = None
