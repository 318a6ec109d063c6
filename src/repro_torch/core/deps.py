"""Block-level dynamic dependence analysis (the BDDT algorithm, §3.3).

For every block (tile) the analyzer keeps metadata ordering the tasks that
touch it: the last writer and the set of readers since that write.  At spawn
("task initiation") each new task's footprint is walked block-by-block:

  * a READ of block b depends on b's last incomplete writer (RAW);
  * a WRITE of block b depends on b's last incomplete writer (WAW) and on
    every incomplete reader since that write (WAR).

Only tasks whose footprints actually overlap are ordered — the dynamic
analysis "only synchronizes tasks that actually have conflicting memory
footprints", which is the paper's argument for discovering more parallelism
than static synchronization.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING

from .blocks import coerce_mode

if TYPE_CHECKING:  # pragma: no cover
    from .graph import TaskDescriptor

BlockId = tuple[int, tuple[int, ...]]  # (array_id, tile index)

__all__ = ["BlockMeta", "DependenceAnalyzer", "BlockId"]


@dataclass
class BlockMeta:
    """Per-block ordering metadata (BDDT keeps this per allocator block)."""
    last_writer: "TaskDescriptor | None" = None
    readers: list["TaskDescriptor"] = field(default_factory=list)


class DependenceAnalyzer:
    """Discovers dependencies of a new task against all previously spawned,
    still-live tasks, block by block."""

    def __init__(self) -> None:
        self._meta: dict[BlockId, BlockMeta] = {}
        # statistics mirrored in the paper's master-cost discussion
        self.blocks_walked = 0
        self.deps_found = 0

    def _meta_for(self, block: BlockId) -> BlockMeta:
        m = self._meta.get(block)
        if m is None:
            m = self._meta[block] = BlockMeta()
        return m

    def analyze(self, task: "TaskDescriptor") -> set["TaskDescriptor"]:
        """Walk the task footprint; return the set of tasks it must wait for
        and update block metadata to order later tasks after this one."""
        deps: set[TaskDescriptor] = set()

        # Pass 1: collect dependencies from current metadata.
        for mode in task.args:
            for block in mode.region.block_ids:
                self.blocks_walked += 1
                m = self._meta_for(block)
                if mode.READS or mode.WRITES:        # RAW / WAW
                    w = m.last_writer
                    if w is not None and not w.is_complete and w is not task:
                        deps.add(w)
                if mode.WRITES:                      # WAR
                    for r in m.readers:
                        if not r.is_complete and r is not task:
                            deps.add(r)

        # Pass 2: publish this task into the metadata (readers first so an
        # INOUT arg does not register a self-dependency).
        for mode in task.args:
            for block in mode.region.block_ids:
                m = self._meta_for(block)
                if mode.WRITES:
                    m.last_writer = task
                    m.readers = []
                elif mode.READS:
                    if task not in m.readers:
                        m.readers.append(task)

        self.deps_found += len(deps)
        return deps

    def tasks_touching(self, blocks, mode: str = "in") -> set["TaskDescriptor"]:
        """Live tasks a *synchronization* on ``blocks`` must wait for —
        the same rules task initiation applies, so ``wait_on(region)`` is
        exactly the paper's automatic sync scoped to a footprint:

        * ``mode="in"``    — pending writers (the data must be produced);
        * ``mode="out"`` / ``"inout"`` — writers *and* readers (the caller
          intends to overwrite, so WAR orderings count too).
        """
        mode = coerce_mode(mode)
        found: set[TaskDescriptor] = set()
        for block in blocks:
            m = self._meta.get(block)
            if m is None:
                continue
            w = m.last_writer
            if w is not None and not w.is_complete:
                found.add(w)
            if mode != "in":
                for r in m.readers:
                    if not r.is_complete:
                        found.add(r)
        return found

    def forget_completed(self, task: "TaskDescriptor") -> None:
        """Drop references to a released task so metadata stays O(live tasks)
        (the paper recycles descriptors from a pre-allocated pool; stale
        pointers must not keep ordering anybody)."""
        for mode in task.args:
            for block in mode.region.block_ids:
                m = self._meta.get(block)
                if m is None:
                    continue
                if m.last_writer is task:
                    # safe to drop: dep checks filter on is_complete anyway
                    m.last_writer = None
                if task in m.readers:
                    m.readers.remove(task)
                if m.last_writer is None and not m.readers:
                    del self._meta[block]
