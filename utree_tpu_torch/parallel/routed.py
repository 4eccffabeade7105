"""Routed displaced shards: counterpart of the seeded-displacement half of
`utree_tpu/parallel/routed.py` (:282-585), the mode built for a table
larger than one card holds (`--devices N --lookup-mode routed`).

The displaced table is split by seed-bucket range over S shards: shard s
holds the t1 rows and the seed slice of buckets [s*nseed/S, (s+1)*nseed/S),
and every shard holds the one merged spill tail t3.  The batch is split by
rows over the same S shards.  Each data shard computes its windows' keys
and routes (local bucket, key_lo, key_hi) to the bucket's owner through an
all_to_all over fixed-capacity slots; the owner probes its slice; the
values come back by a second all_to_all; the data shard probes the
replicated t3 on a miss, decodes, and turns the ids into `pack_hist` rows
(K2 `histogram_packed`).  A batch in which some (sender, owner) pair needs
more slots than the capacity flags itself in a last column (the psum of
each shard's overflow bit, the same on every row); the pipeline then
dispatches it again through the exact broadcast fallback, in which every
shard probes its own bucket range for the whole batch and the values sum.

One process drives every shard (`mesh.ShardMesh`), so the all_to_all and
the psum are copies between the shard devices, outside any kernel.  The
device work is three kernels, each with its plain PyTorch version here:

  route_displaced  -> K11 `csrc/route_displaced.cu` (plain: route_displaced_plain)
  owner_probe      -> K12 `csrc/owner_probe.cu`, owner_probe[_wide]
                      (plain: owner_probe_plain)
  routed_finish    -> K13 `csrc/routed_finish.cu`, routed_finish[_wide]
                      (plain: routed_finish_plain)

A wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.  The routed canonical-table
steps of `utree_tpu` (:59-279) are ROADMAP A.9.5.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from utree_tpu_torch import kernels
from utree_tpu_torch._u32 import i32, u32
from utree_tpu_torch.lookup import (_first_hit_wide, base_codes_packed,
                                    canonical_bucket3, canonical_keys,
                                    decode_canonical_vals, decode_canonical_wide,
                                    displaced_bucket, displaced_seed, displaced_slot,
                                    extract_windows, histogram_packed, probe_rows,
                                    probe_rows_wide)
from utree_tpu_torch.parallel.mesh import ShardMesh

MAX_SHARDS = 8  # K11 keeps one block count per owner
CAPACITY_FACTOR = 1.3  # routing slots per (sender, owner) over the even share


@dataclasses.dataclass
class ShardedDisplacedIndex:
    t1: np.ndarray      # int32 (S, rows_local, 2*cps)
    seeds: np.ndarray   # int32 (S, per_seed//4) packed u8 seed words
    t3: np.ndarray      # int32 (b3, slots3*cps): merged global spill, replicated
    num_shards: int
    nseed: int          # global seed count (pow2, = S * per-shard count)
    slots3: int
    wide: bool
    num_entries: int

    @classmethod
    def build(cls, index, num_shards: int, *, load: float | None = None,
              spill_budget: int | None = None) -> "ShardedDisplacedIndex":
        """utree_tpu/parallel/routed.py:309-395: partition the canonical
        entries by seed-bucket range, place each shard with one forced slot
        count (concurrently, on threads: the placement is large NumPy
        operations that release the GIL), merge the spills into one t3.
        The shard count must be a power of two, so that it divides the
        power-of-two seed count."""
        from concurrent.futures import ThreadPoolExecutor, as_completed

        from utree_tpu_torch.hash_index import (_DISP_LOAD, _DISP_SPILL_BUDGET,
                                                _canonical_groups, build_spill_t3,
                                                displaced_buckets_np,
                                                displaced_nseed, place_displaced_core)

        S = num_shards
        if S < 1 or S & (S - 1):
            raise ValueError(f"routed shards need a power-of-two shard count, got {S}")
        load = _DISP_LOAD if load is None else load
        spill_budget = _DISP_SPILL_BUDGET if spill_budget is None else spill_budget
        key_lo, key_hi, vals, cpre, chi, clo, ng = _canonical_groups(index)
        nseed = displaced_nseed(ng)
        while nseed % S:  # S must divide the pow2 seed count
            nseed *= 2
        bucket = displaced_buckets_np(cpre, chi, clo, nseed)
        per_seed = nseed // S
        owner = bucket // per_seed
        order = np.argsort(owner, kind="stable")
        counts = np.bincount(owner, minlength=S)
        del owner
        bounds = np.zeros(S + 1, np.int64)
        np.cumsum(counts, out=bounds[1:])
        nslots = max(int(int(counts.max()) / load) & ~1, 64)

        def place_shard(s: int):
            idx_s = order[bounds[s]:bounds[s + 1]]
            t1_s, seeds_s, spilled_s = place_displaced_core(
                key_lo[idx_s], key_hi[idx_s], vals[idx_s],
                cpre[idx_s], chi[idx_s], clo[idx_s], len(idx_s),
                load=load, spill_budget=spill_budget,
                bucket=bucket[idx_s] - s * per_seed, nseed=per_seed,
                nslots_force=nslots)
            return t1_s, seeds_s, idx_s[spilled_s]

        # each shard's arrays go into the stacked ones as it finishes, so
        # the shards' results are never held twice
        t1_all = seeds_all = None
        spills: list = [None] * S
        with ThreadPoolExecutor(max_workers=min(S, os.cpu_count() or 1)) as pool:
            futs = {pool.submit(place_shard, s): s for s in range(S)}
            for f in as_completed(futs):
                s = futs[f]
                t1_s, seeds_s, spills[s] = f.result()
                if t1_all is None:
                    t1_all = np.empty((S,) + t1_s.shape, t1_s.dtype)
                    seeds_all = np.empty((S,) + seeds_s.shape, seeds_s.dtype)
                t1_all[s] = t1_s
                seeds_all[s] = seeds_s
        spilled = np.concatenate(spills)
        if len(spilled) > spill_budget:
            raise ValueError(
                f"sharded displaced spill {len(spilled)} exceeds the cached budget")
        t3 = build_spill_t3(spilled, key_lo, key_hi, vals, cpre, chi, clo)
        return cls(t1=t1_all, seeds=seeds_all, t3=t3, num_shards=S, nseed=nseed,
                   slots3=t3.shape[1] // (2 + vals.shape[1]),
                   wide=vals.shape[1] == 2, num_entries=ng)

    def to_devices(self, mesh: ShardMesh) -> list[dict[str, torch.Tensor]]:
        """Shard s's {"t1", "ds", "t3"} int32 tensors on mesh device s: its
        t1 rows and seed words, and the whole t3 (replicated)."""
        if mesh.size != self.num_shards:
            raise ValueError(f"{self.num_shards} shards on a mesh of {mesh.size}")
        return [{"t1": torch.from_numpy(np.ascontiguousarray(self.t1[s])).to(dev),
                 "ds": torch.from_numpy(np.ascontiguousarray(self.seeds[s])).to(dev),
                 "t3": torch.from_numpy(self.t3).to(dev)}
                for s, dev in enumerate(mesh.devices)]


# ---- plain versions ---------------------------------------------------------

def route_displaced_plain(packed, vbits, lens, *, nseed: int, num_shards: int,
                          capacity: int):
    """Plain version of K11 (routed.py:427-441 with the lane set-up of
    :492-500): one data shard's packed reads, all W = L-31 windows a row ->
    (send (S, C, 3), rec (B*W, 4), counts (S+1,)), all int32.  A lane's rank
    is its place among the valid lanes of its owner in lane order p = b*W+w;
    a lane of rank >= C is not routed (mode="drop").  rec holds (slot =
    owner*C + rank or -1, key_lo, key_hi, valid | fwd_le<<1), (-1, 0, 0, 0)
    for an invalid window; counts the valid lanes of each owner, then 1 if
    any exceeds C."""
    S, C = num_shards, capacity
    qpre, qhi, qlo, valid = extract_windows(base_codes_packed(packed, vbits, lens))
    key_lo, key_hi, fwd_le = canonical_keys(qpre, qhi, qlo)
    gbkt = displaced_bucket(key_lo, key_hi, valid, nseed).reshape(-1)
    valid, fwd_le = valid.reshape(-1), fwd_le.reshape(-1)
    klo = torch.where(valid, i32(key_lo.reshape(-1)).long(), 0)
    khi = torch.where(valid, i32(key_hi.reshape(-1)).long(), 0)
    per_seed = nseed // S
    owner = gbkt // per_seed
    local = gbkt - owner * per_seed
    rank = torch.zeros_like(gbkt)
    counts = []
    for s in range(S):
        m = valid & (owner == s)
        rank = torch.where(m, torch.cumsum(m.long(), 0) - 1, rank)
        counts.append(m.sum())
    routable = valid & (rank < C)
    counts.append((valid & (rank >= C)).any().long())
    send = torch.zeros((S, C, 3), dtype=torch.int32, device=packed.device)
    send[owner[routable], rank[routable]] = torch.stack(
        [local, klo, khi], 1)[routable].to(torch.int32)
    rec = torch.stack([torch.where(routable, owner * C + rank, -1), klo, khi,
                       torch.where(valid, 1 | (fwd_le.long() << 1), 0)], 1)
    return send, rec.to(torch.int32), torch.stack(counts).to(torch.int32)


def owner_probe_plain(t1, seeds, lanes, *, base: int, per_seed: int, wide: bool):
    """Plain version of K12, `_displaced_local_probe` (routed.py:405-419)
    on (N, 3) int32 lanes (bucket, key_lo, key_hi) of one shard's slice:
    (N,) raw values (narrow) or (N, 2) pairs (wide).  A lane whose bucket
    lies outside [base, base + per_seed) gives 0 (the fallback's `mine`)."""
    bkt = lanes[:, 0].long()
    klo, khi = u32(lanes[:, 1]), u32(lanes[:, 2])
    mine = (bkt >= base) & (bkt < base + per_seed)
    local = torch.where(mine, bkt - base, 0)
    seed = displaced_seed(seeds, local)
    slot = displaced_slot(klo, khi, seed, torch.ones_like(mine), 2 * t1.shape[0])
    rows = t1[slot >> 1]
    if wide:
        va, vb = probe_rows_wide(rows, klo, khi, 2)
        return torch.stack([torch.where(mine, va, 0), torch.where(mine, vb, 0)], 1)
    return torch.where(mine, probe_rows(rows, klo, khi, 2), 0)


def displaced_t3_tail(val, t3, key_lo, key_hi, valid, wide: bool):
    """`_displaced_t3_tail` (routed.py:462-474): where the value misses, the
    replicated t3's (an 8-row t3 is the "absent" sentinel); `val` is the
    raw value (narrow) or the (va, vb) pair (wide); keys are u32 lanes."""
    if t3.shape[0] <= 8:
        return val
    rows = t3[canonical_bucket3(key_lo, key_hi, valid, t3.shape[0])]
    if wide:
        return _first_hit_wide(*val, probe_rows_wide(rows, key_lo, key_hi,
                                                     t3.shape[1] // 4))
    return torch.where(val != 0, val, probe_rows(rows, key_lo, key_hi, t3.shape[1] // 3))


def routed_finish_plain(rec, reply, t3, *, b: int, w: int, do_rc: bool,
                        bad_ix: int, wide: bool):
    """Plain version of K13: each lane's value from `reply` at its record's
    slot (0 for slot -1), the t3 tail, the decode (routed.py:444-459,
    :507-518) -> (b, 2w) ids with RC, else (b, w)."""
    slot = rec[:, 0].long()
    klo, khi = u32(rec[:, 1]), u32(rec[:, 2])
    valid, fwd_le = (rec[:, 3] & 1) == 1, (rec[:, 3] & 2) == 2
    has, at = slot >= 0, slot.clamp(min=0)
    vm, fm = valid.reshape(b, w), fwd_le.reshape(b, w)
    if wide:
        rep = reply.reshape(-1, 2)
        va, vb = displaced_t3_tail((torch.where(has, rep[at, 0], 0),
                                    torch.where(has, rep[at, 1], 0)),
                                   t3, klo, khi, valid, True)
        r = decode_canonical_wide(va.reshape(b, w), vb.reshape(b, w), vm, fm,
                                  bad_ix, do_rc)
    else:
        val = displaced_t3_tail(torch.where(has, reply.reshape(-1)[at], 0),
                                t3, klo, khi, valid, False)
        r = decode_canonical_vals(val.reshape(b, w), vm, fm, bad_ix, do_rc)
    return torch.cat(r, dim=1) if do_rc else r


# ---- kernel wrappers ----------------------------------------------------------

def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def route_displaced(packed, vbits, lens, *, nseed: int, num_shards: int, capacity: int):
    """K11 `route_displaced` on CUDA tensors; `route_displaced_plain` on
    CPU tensors."""
    if packed.device.type == "cpu":
        return route_displaced_plain(packed, vbits, lens, nseed=nseed,
                                     num_shards=num_shards, capacity=capacity)
    dev = packed.device
    kernels.require(packed, "packed", torch.uint8, 2, dev)
    kernels.require(vbits, "vbits", torch.uint8, 2, dev)
    kernels.require(lens, "lens", torch.int32, 1, dev)
    b, row4 = packed.shape
    row8 = vbits.shape[1]
    if lens.shape[0] != b or vbits.shape[0] != b or row8 * 2 != row4:
        raise ValueError("packed/vbits/lens shapes disagree")
    w = row4 * 4 - 31
    if w <= 0:
        raise ValueError("reads shorter than k after padding")
    S, C = num_shards, capacity
    if not 1 <= S <= MAX_SHARDS or nseed < S or nseed % S or nseed & (nseed - 1):
        raise ValueError(f"route_displaced takes 1..{MAX_SHARDS} shards dividing a "
                         f"power-of-two seed count ({S} shards, nseed {nseed})")
    if C < 1:
        raise ValueError(f"capacity {C} < 1")
    tiles = max(1, -(-(b * w) // 1024))
    send = torch.empty((S, C, 3), dtype=torch.int32, device=dev)
    rec = torch.empty((b * w, 4), dtype=torch.int32, device=dev)
    counts = torch.empty(S + 1, dtype=torch.int32, device=dev)
    scratch = torch.empty((2, tiles * S), dtype=torch.int32, device=dev)
    kernels.launch("route_displaced", packed.data_ptr(), vbits.data_ptr(),
                   lens.data_ptr(), b, row4, row8, w, nseed, S, C,
                   scratch[0].data_ptr(), scratch[1].data_ptr(), send.data_ptr(),
                   rec.data_ptr(), counts.data_ptr(), _stream(dev))
    return send, rec, counts


def owner_probe(t1, seeds, lanes, *, base: int, per_seed: int, wide: bool):
    """K12 `owner_probe[_wide]` on CUDA tensors; `owner_probe_plain` on CPU
    tensors."""
    if lanes.device.type == "cpu":
        return owner_probe_plain(t1, seeds, lanes, base=base, per_seed=per_seed,
                                 wide=wide)
    dev = lanes.device
    cps = 4 if wide else 3
    kernels.require(lanes, "lanes", torch.int32, 2, dev)
    kernels.require(t1, "t1", torch.int32, 2, dev)
    kernels.require(seeds, "ds", torch.int32, 1, dev)
    if lanes.shape[1] != 3 or t1.shape[1] != 2 * cps or t1.shape[0] < 1:
        raise ValueError(f"owner_probe takes (N, 3) lanes and 2-slot t1 rows of "
                         f"{2 * cps} columns, got {tuple(lanes.shape)}, {tuple(t1.shape)}")
    if not 1 <= per_seed <= 4 * seeds.shape[0]:
        raise ValueError(f"per_seed {per_seed} outside the {seeds.shape[0]} seed words")
    n = lanes.shape[0]
    out = torch.empty((n, 2) if wide else (n,), dtype=torch.int32, device=dev)
    kernels.launch("owner_probe" + ("_wide" if wide else ""), lanes.data_ptr(), n,
                   base, per_seed, t1.data_ptr(), 2 * t1.shape[0], seeds.data_ptr(),
                   out.data_ptr(), _stream(dev))
    return out


def routed_finish(rec, reply, t3, *, b: int, w: int, do_rc: bool, bad_ix: int,
                  wide: bool):
    """K13 `routed_finish[_wide]` on CUDA tensors; `routed_finish_plain` on
    CPU tensors."""
    if rec.device.type == "cpu":
        return routed_finish_plain(rec, reply, t3, b=b, w=w, do_rc=do_rc,
                                   bad_ix=bad_ix, wide=wide)
    dev = rec.device
    cps = 4 if wide else 3
    kernels.require(rec, "rec", torch.int32, 2, dev)
    kernels.require(reply, "reply", torch.int32, reply.dim(), dev)
    kernels.require(t3, "t3", torch.int32, 2, dev)
    n3 = t3.shape[0]
    if rec.shape != (b * w, 4):
        raise ValueError(f"rec {tuple(rec.shape)} is not ({b * w}, 4)")
    if t3.shape[1] % cps or n3 < 1 or n3 & (n3 - 1):
        raise ValueError(f"t3 {tuple(t3.shape)} is no power-of-two table of "
                         f"{cps}-column slots")
    out = torch.empty((b, 2 * w if do_rc else w), dtype=torch.int32, device=dev)
    kernels.launch("routed_finish" + ("_wide" if wide else ""), rec.data_ptr(),
                   reply.data_ptr(), b, w, t3.data_ptr(), n3, t3.shape[1] // cps,
                   int(do_rc), bad_ix, out.data_ptr(), _stream(dev))
    return out


# ---- the steps --------------------------------------------------------------------

def _shard_rows(mesh: ShardMesh, s: int, rows: slice, *tensors):
    return [t[rows].to(mesh.devices[s], non_blocking=True) for t in tensors]


def routed_displaced_search_step(mesh: ShardMesh, sharded: ShardedDisplacedIndex, *,
                                 do_rc: bool, num_labels: int, cap: int, bad_ix: int,
                                 capacity: int | None = None):
    """`routed_displaced_search_step` (routed.py:477-532): returns
    step(tables, packed, vbits, lens) -> one (B/S, cap+2) int32 tensor a
    shard, on its device, in row order: `pack_hist` rows and the overflow
    column.  `tables` is `sharded.to_devices(mesh)`; the batch's rows
    divide over the S shards, and every one of the L-31 windows of the
    padded width is probed, as JAX's step does."""
    S = sharded.num_shards
    if mesh.size != S:
        raise ValueError(f"{S} shards on a mesh of {mesh.size}")
    per_seed = sharded.nseed // S
    bad_ix = min(bad_ix, 0x7FFFFFFF)

    def step(tables, packed, vbits, lens):
        if packed.shape[0] % S:
            raise ValueError(f"{packed.shape[0]} rows do not divide over {S} shards")
        b_loc = packed.shape[0] // S
        w = packed.shape[1] * 4 - 31
        p = b_loc * w
        c = capacity if capacity is not None else max(
            128, int(np.ceil(p / S * CAPACITY_FACTOR / 128)) * 128)
        sends, recs, flags = [], [], []
        for s in range(S):
            with mesh.on(s):
                send, rec, counts = route_displaced(
                    *_shard_rows(mesh, s, slice(s * b_loc, (s + 1) * b_loc),
                                 packed, vbits, lens),
                    nseed=sharded.nseed, num_shards=S, capacity=c)
            sends.append(send)
            recs.append(rec)
            flags.append(counts[S:])
        recv = mesh.all_to_all(sends)
        vals = []
        for o in range(S):
            with mesh.on(o):
                v = owner_probe(tables[o]["t1"], tables[o]["ds"], recv[o].reshape(S * c, 3),
                                base=0, per_seed=per_seed, wide=sharded.wide)
            vals.append(v.reshape((S, c, 2) if sharded.wide else (S, c)))
        reply = mesh.all_to_all(vals)
        oflo = mesh.psum(flags)  # identical on every shard
        out = []
        for s in range(S):
            with mesh.on(s):
                ids = routed_finish(recs[s], reply[s], tables[s]["t3"], b=b_loc, w=w,
                                    do_rc=do_rc, bad_ix=bad_ix, wide=sharded.wide)
                rows = histogram_packed(ids, num_labels, cap)
                out.append(torch.cat([rows, oflo[s].expand(b_loc, 1)], dim=1))
        return out

    return step


def routed_displaced_fallback_step(mesh: ShardMesh, sharded: ShardedDisplacedIndex, *,
                                   do_rc: bool, num_labels: int, cap: int, bad_ix: int):
    """`routed_displaced_fallback_step` (routed.py:535-585): returns
    step(tables, packed, vbits, lens) -> [(B, cap+1) int32 `pack_hist`
    rows] on shard 0's device.  The lanes of the whole batch (K11 as one
    shard with room for every lane) go to every shard, each probes its own
    bucket range (K12 with base s*nseed/S), the values sum, and shard 0
    finishes (K13, K2)."""
    S = sharded.num_shards
    if mesh.size != S:
        raise ValueError(f"{S} shards on a mesh of {mesh.size}")
    per_seed = sharded.nseed // S
    bad_ix = min(bad_ix, 0x7FFFFFFF)

    def step(tables, packed, vbits, lens):
        b = packed.shape[0]
        w = packed.shape[1] * 4 - 31
        with mesh.on(0):
            lanes, rec, _ = route_displaced(
                *_shard_rows(mesh, 0, slice(0, b), packed, vbits, lens),
                nseed=sharded.nseed, num_shards=1, capacity=max(1, b * w))
        lanes = lanes.reshape(-1, 3)
        vals = []
        for s, dev in enumerate(mesh.devices):
            with mesh.on(s):
                vals.append(owner_probe(tables[s]["t1"], tables[s]["ds"],
                                        lanes.to(dev, non_blocking=True),
                                        base=s * per_seed, per_seed=per_seed,
                                        wide=sharded.wide))
        summed = mesh.reduce(vals)[0]
        with mesh.on(0):
            ids = routed_finish(rec, summed, tables[0]["t3"], b=b, w=w, do_rc=do_rc,
                                bad_ix=bad_ix, wide=sharded.wide)
            return [histogram_packed(ids, num_labels, cap)]

    return step
