"""Home-aware mesh execution: the ShardedExecutor.

The paper's central performance lesson is that memory locality dominates on
non cache-coherent machines: BDDT-SCC stripes application data across the
SCC's four memory controllers and keeps tasks near the controller serving
their blocks (§4.1-§4.2).  On a device mesh the same policy is
*owner-computes*: every block already has a home (``placement.assign_homes``),
:func:`~repro_torch.core.placement.device_assignment` maps homes
block-cyclically onto the mesh's devices, and each task executes on the
home device of its *output* footprint.  Reads of blocks homed elsewhere
are cross-home transfers — the mesh analogue of the remote-controller
accesses the DES (``sim.py``) charges contention for — and this executor
records them in ``RuntimeStats`` (``cross_home_bytes`` /
``local_home_bytes``) so the benchmark tables can show what a placement
policy saves.

Residency: blocks are *device-resident*.  :meth:`ShardedExecutor.make_store`
hands every registered ``BlockArray`` a
:class:`~repro_torch.core.blocks.DeviceTileStore`, so each tile lives on
the (logical) device serving its home.  A grouped wave dispatch assembles
every device's operand shard *on that device*
(``Region.materialize(device=...)`` inside :meth:`_sharded_stack`): tiles
a task owns never move, a cross-home read copies exactly once, and
nothing routes through a staging device — ``RuntimeStats.bytes_staged``
stays zero, and ``tile_moves``/``bytes_moved`` report the copies that
actually happened (measured at the memory layer by
:class:`~repro_torch.core.blocks.TileTraffic`).  Results come back
shard-by-shard (:meth:`_store_sharded` reads each task's output from the
shard computed on its executing device) and commit tile-by-tile to the
output's home.

Dispatch reuses the staged executor's wavefront grouping unchanged: tasks
of one wavefront with the same function and footprint/value structure
stack into one batched call.  With a mesh context active
(:func:`repro_torch.dist.use_mesh`) that call is split over the mesh: the
stacked task axis is cut into contiguous per-device chunks in
``mesh.devices.flat`` order (tasks sorted by owner, so each device's
chunk is, under block-cyclic homes, the tasks it owns) and each chunk runs
as one ``torch.func.vmap(fn)`` call on its device — the reference's
``jit(shard_map(vmap(fn)))`` with one controller driving every device.
Groups a mesh cannot split evenly fall back to per-owner-device
sub-dispatches, and with no mesh at all every dispatch degrades to the
plain staged path, wave kernels included.

When ``RuntimeConfig.owner_skew_threshold`` is set, a wave group whose
owner loads are badly skewed is rebalanced before dispatch
(:func:`~repro_torch.core.placement.rebalance_owners`): surplus tasks of
the hottest home spill to the least-loaded one, and the spilled task's
output copy home is charged for real by the device store — contention
traded against one counted copy, the override the paper's Fig 4 numbers
argue for.
"""
from __future__ import annotations

from collections import defaultdict

import torch

from .api import suspend_runtime_scope
from .blocks import DeviceTileStore, _locate
from .executor import StagedExecutor, _run_one, on_device
from .graph import TaskDescriptor, TaskState, normalize_outputs
from .placement import device_assignment, rebalance_owners

__all__ = ["ShardedExecutor", "owner_home"]


def owner_home(td: TaskDescriptor) -> int:
    """Owner-computes: a task belongs to the home of its first output
    block (the paper's locality-aware scheduling keyed on where the task's
    result lives, not where its inputs came from)."""
    for m in td.args:
        if m.WRITES:
            return m.region.array.home.get(m.region.tile_indices[0], 0)
    return 0


class ShardedExecutor(StagedExecutor):
    """Staged wavefronts, placed home-aware on the ambient device mesh."""

    kind = "sharded"

    def __init__(self, graph, scheduler, device: torch.device,
                 group: bool = True, n_homes: int = 4,
                 owner_skew_threshold: float = 0.0,
                 kernel_backend: str = "xla"):
        super().__init__(graph, scheduler, device, group=group,
                         kernel_backend=kernel_backend)
        self.n_homes = n_homes
        self.owner_skew_threshold = owner_skew_threshold
        self.sharded_dispatches = 0
        self.cross_home_bytes = 0
        self.local_home_bytes = 0
        self.owner_overrides = 0

    # -- placement ----------------------------------------------------------
    def _mesh_ctx(self):
        """The ambient mesh context, or None; raises when the runtime's
        device is not one the mesh's devices live on."""
        from .. import dist
        ctx = dist.current()
        if ctx is not None and self.device not in ctx.mesh.torch_devices:
            raise ValueError(
                f"the runtime runs on {self.device}, the mesh on "
                f"{list(map(str, ctx.mesh.torch_devices))}: pass "
                "RuntimeConfig(device=...) naming one of the mesh's devices")
        return ctx

    def make_store(self, ba):
        """The runtime's residency hook: with a mesh active, give ``ba`` a
        device-resident store so its tiles live on their home devices from
        allocation onward (``from_array``/``zeros``/``full`` place each
        tile per ``device_assignment``).  Without a mesh the host store
        stays — the single-device fallback."""
        ctx = self._mesh_ctx()
        if ctx is None:
            return None
        return DeviceTileStore(ba, device_assignment(self.n_homes, ctx),
                               traffic=ba.traffic)

    def _account(self, td: TaskDescriptor, owner: int) -> None:
        """Charge every footprint block against the owner home: blocks
        homed elsewhere are cross-home traffic (what ``sim.py`` turns into
        controller contention), blocks at the owner are local.  The counts
        are policy-level — what owner-computes *must* move — independent
        of how many devices back the homes, so the single-device fallback
        reports the same numbers a real mesh would.  (The *measured*
        movement lives in the runtime's ``TileTraffic``.)"""
        for m in td.args:
            arr = m.region.array
            block_bytes = arr.tile_nbytes
            for idx in m.region.tile_indices:
                if arr.home.get(idx, 0) != owner:
                    self.cross_home_bytes += block_bytes
                else:
                    self.local_home_bytes += block_bytes

    def _owners(self, group: list[TaskDescriptor]) -> list[int]:
        owners = [owner_home(td) for td in group]
        if self.owner_skew_threshold > 0:
            base = None
            if self.obs.enabled:
                # the tracker's live per-home queue depth: work of this
                # wave still queued behind each home ("queued, not yet
                # dispatched" — this group was dequeued before placement,
                # so it is not double-counted)
                depths = self.obs.queue_depths()
                base = [max(0, depths.get(h, 0))
                        for h in range(self.n_homes)]
            owners, spilled = rebalance_owners(
                owners, self.n_homes, self.owner_skew_threshold,
                base_load=base)
            self.owner_overrides += spilled
            if spilled and self.obs.enabled:
                self.obs.emit("owner_override", wave=self._wave_id,
                              spilled=spilled)
        return owners

    # -- queue accounting (per owner-home channel) ----------------------------
    def _home_counts(self, tds: list[TaskDescriptor]):
        counts: dict[int, int] = defaultdict(int)
        for td in tds:
            counts[owner_home(td) % self.n_homes] += 1
        return counts

    def _enqueue_wave(self, wave: list[TaskDescriptor]) -> None:
        for home, n in sorted(self._home_counts(wave).items()):
            self.obs.queue(home, n)

    def _dequeue_group(self, group: list[TaskDescriptor]) -> None:
        # keyed on the raw owner home (pre-rebalance), matching enqueue
        for home, n in sorted(self._home_counts(group).items()):
            self.obs.queue(home, -n)

    # -- dispatch -----------------------------------------------------------
    def _run_group(self, group: list[TaskDescriptor]) -> None:
        owners = self._owners(group)
        for td, h in zip(group, owners):
            self._account(td, h)
        ctx = self._mesh_ctx()
        if ctx is None:
            # single-device fallback: identical to the staged executor
            # (including its wave-kernel attempt when
            # kernel_backend="pallas")
            return super()._run_group(group)
        if self.kernel_backend == "pallas":
            # under a live mesh the group dispatches per device; one wave
            # kernel launch would pin the whole wave to one device and
            # undo owner-computes, so the mesh path is a named fallback
            self._note_kernel_fallback(group, "sharded_mesh")
        mesh = ctx.mesh
        devmap = device_assignment(self.n_homes, ctx)
        ndev = mesh.size
        if len(group) == 1 or not self.group:
            for td, h in zip(group, owners):
                _run_one(td, device=devmap[h % len(devmap)])
            return
        # sort by owner device so the split task axis hands each device
        # (under balanced block-cyclic homes) exactly the tasks it owns
        order = sorted(range(len(group)), key=lambda i: owners[i] % ndev)
        group = [group[i] for i in order]
        owners = [owners[i] for i in order]
        if len(group) % ndev == 0:
            self._run_sharded(group, mesh)
        else:
            # a wave the mesh cannot split evenly: owner-computes
            # sub-dispatches, one batched call per owner device
            by_dev = defaultdict(list)
            for td, h in zip(group, owners):
                by_dev[devmap[h % len(devmap)]].append(td)
            for dev, sub in by_dev.items():
                self._run_subgroup_on(sub, dev)

    def _sharded_stack(self, group: list[TaskDescriptor],
                       sharding) -> tuple[list, list]:
        """Assemble each stacked operand (READS args then firstprivate
        values, the staged stacking order) shard by shard: every device's
        shard is built *on that device* by destination-aware assembly —
        tiles resident there are read in place, a cross-home tile copies
        once, and no operand ever routes through a staging device.
        Returns ``(shards, slices)``: ``shards[k]`` holds device ``k``'s
        operands, ``slices`` the per-device ``(device, lo, hi)`` split of
        the task axis (``_store_sharded`` reads results back along it)."""
        n = len(group)
        slices = [(dev, *idx[0].indices(n)[:2])
                  for dev, idx in sharding.devices_indices_map((n,)).items()]
        pulls = self._pulls(group)
        shards = [[torch.stack([pull(i, dev) for i in range(lo, hi)])
                   for pull in pulls]
                  for dev, lo, hi in slices]
        return shards, slices

    def _store_sharded(self, group: list[TaskDescriptor], results: list,
                       slices: list) -> None:
        """Unstack the per-device results without cross-device gathers:
        each device's result holds exactly the tasks that ran there, so
        every task's value is read from the shard on its executing device
        and committed tile-by-tile to its output's home (a no-op when
        owner-computes held; one counted copy when the owner override
        spilled the task)."""
        n_out = len(group[0].outputs)
        label = group[0].name or group[0].tid
        self.grouped_dispatches += 1
        for result, (dev, lo, hi) in zip(results, slices):
            result = normalize_outputs(result, n_out, label)
            for i in range(lo, hi):
                self._assign_outputs(
                    group[i],
                    tuple(_locate(data[i - lo], dev) for data in result))

    def _run_sharded(self, group: list[TaskDescriptor], mesh) -> None:
        """The per-device hybrid: stacked operands are split along the
        task axis over every mesh axis; on each device ``vmap`` maps the
        local chunk."""
        from .. import dist

        fn = group[0].fn
        for td in group:
            td.state = TaskState.RUNNING
        spec = dist.PartitionSpec(tuple(mesh.axis_names))
        shards, slices = self._sharded_stack(
            group, dist.NamedSharding(mesh, spec))
        vfn = self._vmapped_fn(fn)
        self._last_mode = "shard_map"
        results = []
        with suspend_runtime_scope():    # vmap runs fn on this thread
            for ins, (dev, _, _) in zip(shards, slices):
                with on_device(dev):
                    results.append(vfn(*ins))
        self.sharded_dispatches += 1
        self._store_sharded(group, results, slices)

    def _run_subgroup_on(self, group: list[TaskDescriptor], dev) -> None:
        """Batched vmap dispatch pinned to one owner device (the uneven-
        wave fallback; computation follows the placed operands)."""
        if len(group) == 1:
            _run_one(group[0], device=dev)
            return
        for td in group:
            td.state = TaskState.RUNNING
        ins = self._stack_group(group, device=dev)
        vfn = self._vmapped_fn(group[0].fn)
        self._last_mode = "vmap_device"
        with suspend_runtime_scope(), on_device(dev):
            result = vfn(*ins)
        self._store_group(group, result, device=dev)
