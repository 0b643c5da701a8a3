"""The port's route and size decisions, by device.

Four decisions choose between exact routes; none changes an output:

- ``hash_budget``: the device bytes a probe table's assembly may hold
  (``index/device_build.py``).  Over it a device build's ``auto`` takes
  the sort join and a host index's table is built on the host;
- ``device_build_min``/``device_build_max``: the genome bases that
  ``dumpalign -g`` builds on the device (``cli.py``);
- ``auto_hash_min_keys``: above it ``auto`` takes the 16-slot table at
  k <= 31 (``reference.py``);
- ``auto_batch``: the batch of ``batch_size=0`` (``aligner.py``).

On a CUDA device the values are the H100's, derived from measurements on
the card (``PERF.md``, "Route and size constants", which names the tool
and the numbers behind each); the budget is a function of the card's
memory and of the processes that share the card, never of the memory free
at the time, so a route does not depend on transient state.  Elsewhere
(the CPU, the tests' device) they are the JAX package's, set on a TPU, so
the port routes there as the JAX package does.  The environment variables
``$SHOTGUN_TPU_HASH_HBM_BUDGET``, ``$SHOTGUN_TPU_DEVICE_BUILD_MIN``/``_MAX``
and ``$SHOTGUN_TPU_PROBE`` override either, where each decision is read.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import torch
import torch.distributed as dist

from shotgun_tpu_torch.parallel.distributed import card_of


class Routes(NamedTuple):
    hash_budget: int          # bytes
    device_build_min: int     # genome bases
    device_build_max: int     # genome bases
    auto_hash_min_keys: int   # distinct k-mers
    batch_small: int          # reads a batch below ``large_from_reads``
    batch_large: int          # reads a batch from ``large_from_reads`` on
    large_from_reads: int

    def auto_batch(self, est_reads: int) -> int:
        """The batch of ``batch_size=0`` for about ``est_reads`` reads
        (output does not depend on it)."""
        return self.batch_large if est_reads >= self.large_from_reads else self.batch_small


#: the JAX package's values (its ``index/device_build.py:470-477``,
#: ``cli.py:315-324``, ``reference.py:549-552``, ``aligner.py:105-111``)
JAX_ROUTES = Routes(hash_budget=10_000_000_000, device_build_min=4_000_000,
                    device_build_max=64_000_000, auto_hash_min_keys=8_000_000,
                    batch_small=2048, batch_large=32768, large_from_reads=131_072)

#: the H100's, each from PERF.md's "Route and size constants": the least
#: measured genome size from which the device build and its table, the
#: device route's one-time cost included, were no slower than the host
#: build and its table; the largest size run through the CLI's device
#: build on the card; the largest measured key count at which the sort
#: join, over a run's CARD_BATCH batches, was no slower than the 16-slot
#: table with its making, for both kinds of reference; the batch that was
#: no slower on any input, small inputs included
CARD_DEVICE_BUILD_MIN = 4_000_000
CARD_DEVICE_BUILD_MAX = 200_000_000
CARD_AUTO_HASH_MIN_KEYS = 32_000_000
CARD_BATCH = 65536
#: the caching allocator reserved up to this many bytes for each byte
#: allocated at the device build's peak, so a process's share of the card
#: is divided by it
RESERVED_PER_ALLOCATED = 2
#: device bytes beside a table's assembly: a device build's rows at rest
#: (int64 key, int32 set id and genome count) a base of
#: CARD_DEVICE_BUILD_MAX, and the stream's working set above its table at
#: CARD_BATCH reads
ROW_BYTES_PER_BASE = 16
STREAM_BYTES = 841_558_528


def card_routes(total_memory: int, procs: int = 1) -> Routes:
    """The H100's values on a card of ``total_memory`` bytes that ``procs``
    processes share: each process's budget is its share of the card, over
    RESERVED_PER_ALLOCATED, less what sits beside a table's assembly."""
    beside = ROW_BYTES_PER_BASE * CARD_DEVICE_BUILD_MAX + STREAM_BYTES
    return Routes(hash_budget=total_memory // (RESERVED_PER_ALLOCATED * procs) - beside,
                  device_build_min=CARD_DEVICE_BUILD_MIN,
                  device_build_max=CARD_DEVICE_BUILD_MAX,
                  auto_hash_min_keys=CARD_AUTO_HASH_MIN_KEYS,
                  batch_small=CARD_BATCH, batch_large=CARD_BATCH, large_from_reads=0)


def procs_per_card(card: int) -> int:
    """The processes of this job that compute on card ``card``: the ranks
    of the process group that ``parallel.distributed.card_of`` places
    there, 1 without a group."""
    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return sum(1 for r in range(dist.get_world_size()) if card_of(r) == card)


def device_routes(device: Union[str, torch.device]) -> Routes:
    """The values for ``device``: the H100's on a CUDA device, from its
    card's total memory and ``procs_per_card``; the JAX package's
    elsewhere."""
    device = torch.device(device)
    if device.type != "cuda":
        return JAX_ROUTES
    card = torch.cuda.current_device() if device.index is None else device.index
    return card_routes(torch.cuda.get_device_properties(card).total_memory,
                       procs_per_card(card))
