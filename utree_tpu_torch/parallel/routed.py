"""Routed shards: counterpart of `utree_tpu/parallel/routed.py`, the steps
that split a table larger than one card holds over the `table` axis of a
(data, table) mesh and route each window's key to the shard that owns it.

Two tables are routed.  The seeded-displacement table (:282-585; the
pipeline's `--devices N --lookup-mode routed`) is split by seed-bucket
range: shard s holds the t1 rows and the seed slice of buckets [s*nseed/S,
(s+1)*nseed/S), and every shard holds the one merged spill tail t3.  The
canonical hash table (:59-279; no pipeline path, as in `utree_tpu`) is
split by t1 bucket range: shard s holds rows [s*b1/S, (s+1)*b1/S) of t1,
and every shard holds t2 and t3 whole.

The routed step splits the batch's rows over all D*S devices in mesh
order.  Each device computes its windows' keys and routes (local bucket,
key_lo, key_hi) to the bucket's owner within its data row through an
all_to_all over fixed-capacity slots; the owner probes its slice; the
values come back by a second all_to_all; the device probes the replicated
tail on a miss, decodes, and turns the ids into `pack_hist` rows (K2
`histogram_packed`).  A batch in which some (sender, owner) pair needs
more slots than the capacity flags itself in a last column (the psum of
each device's overflow bit over the whole mesh, the same on every row);
the caller then dispatches it again through the exact broadcast fallback,
which splits the rows over `data` only: every table shard of a data row
probes its own bucket range for the row's whole batch and the values sum
over `table`.

One process drives every device (`mesh.ShardMesh`), so the all_to_all and
the sums are copies between the devices, outside any kernel.  The device
work is kernels, each with its plain PyTorch version here:

  route_displaced  -> K11 `csrc/route_displaced.cu` (plain: route_displaced_plain),
                      both tables: the canonical t1 bucket is the displaced
                      seed bucket's fold, masked to b1 in place of nseed
  owner_probe      -> K12 `csrc/owner_probe.cu`, owner_probe[_wide]
                      (plain: owner_probe_plain), displaced
  canonical_owner_probe -> K17 `csrc/owner_probe.cu`,
                      canonical_owner_probe[_wide] (plain: canonical_owner_probe_plain)
  routed_finish    -> K13 `csrc/routed_finish.cu`, routed_finish[_wide]
                      (plain: routed_finish_plain), displaced
  routed_canonical_finish -> K18 `csrc/routed_finish.cu`,
                      routed_canonical_finish[_wide] (plain: routed_canonical_finish_plain)

A wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from utree_tpu_torch import kernels
from utree_tpu_torch._u32 import i32, u32
from utree_tpu_torch.hash_index import CanonicalHashArrays
from utree_tpu_torch.lookup import (_first_hit_wide, _row_aligned, base_codes_packed,
                                    canonical_bucket3, canonical_buckets, canonical_keys,
                                    decode_canonical_vals, decode_canonical_wide,
                                    displaced_bucket, displaced_seed, displaced_slot,
                                    extract_windows, histogram_packed, probe_rows,
                                    probe_rows_wide)
from utree_tpu_torch.parallel.mesh import ShardMesh

MAX_SHARDS = 64  # table shards on cards: K11 keeps a (32,) block count per owner
CAPACITY_FACTOR = 1.3  # routing slots per (sender, owner) over the even share


def _check_shards(mesh: ShardMesh, num_shards: int) -> None:
    if mesh.shape[1] != num_shards:
        raise ValueError(f"{num_shards} table shards on a mesh of {mesh.shape}")


def _to_mesh(mesh: ShardMesh, num_shards: int, sharded: dict, replicated: dict):
    """One dict a device in mesh order: shard s's slice of each `sharded`
    array (leading shard axis) and each `replicated` array whole, on the
    device at (d, s), as P("table") and P() place them.  Devices that are
    one device share one copy."""
    _check_shards(mesh, num_shards)
    copies: dict = {}
    out = []
    for i, dev in enumerate(mesh.devices):
        s = i % num_shards
        if (s, dev) not in copies:
            copies[(s, dev)] = {
                **{k: torch.from_numpy(np.ascontiguousarray(a[s])).to(dev)
                   for k, a in sharded.items()},
                **{k: torch.from_numpy(a).to(dev) for k, a in replicated.items()}}
        out.append(copies[(s, dev)])
    return out


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
        """{"t1", "ds", "t3"} int32 tensors a device of a (D, S) mesh, in
        mesh order: the device at (d, s) gets shard s's t1 rows and seed
        words, and the whole t3 (replicated)."""
        return _to_mesh(mesh, self.num_shards, {"t1": self.t1, "ds": self.seeds},
                        {"t3": self.t3})


@dataclasses.dataclass
class ShardedCanonicalIndex:
    """The canonical hash table split for the routed mode (routed.py:60-92):
    t1 stacked on a leading shard axis (bucket-range partition), t2 and t3
    whole (replicated)."""

    t1: np.ndarray  # int32 (S, b1/S, slots*cps)
    t2: np.ndarray  # int32 (b2, slots2*cps)
    t3: np.ndarray  # int32 (b3, slots3*cps); 8-row sentinel = absent
    num_shards: int
    b1: int  # global t1 bucket count
    slots: int
    slots2: int
    slots3: int
    wide: bool = False  # IXTYPE=u32 layout: 4-column slots, (va, vb) value pair

    @classmethod
    def from_canonical(cls, c: CanonicalHashArrays, num_shards: int) -> "ShardedCanonicalIndex":
        wide = c.t1.shape[1] == c.slots * 4
        b1 = c.t1.shape[0]
        if b1 % num_shards:
            raise ValueError("num_shards must divide the t1 bucket count")
        per = b1 // num_shards
        return cls(t1=np.ascontiguousarray(c.t1.reshape(num_shards, per, c.t1.shape[1])),
                   t2=c.t2, t3=c.t3, num_shards=num_shards, b1=b1, slots=c.slots,
                   slots2=c.slots2, slots3=c.slots3, wide=wide)

    def to_devices(self, mesh: ShardMesh) -> list[dict[str, torch.Tensor]]:
        """{"t1", "t2", "t3"} int32 tensors a device of a (D, S) mesh, in
        mesh order: shard s's t1 rows on the device at (d, s), t2 and t3
        whole on every device."""
        return _to_mesh(mesh, self.num_shards, {"t1": self.t1},
                        {"t2": self.t2, "t3": self.t3})


# ---- plain versions ---------------------------------------------------------

def route_displaced_plain(packed, vbits, lens, *, nseed: int, num_shards: int,
                          capacity: int):
    """Plain version of K11 (routed.py:427-441 with the lane set-up of
    :492-500; for the canonical table :130-150 with nseed = b1): one data
    shard's packed reads, all W = L-31 windows a row -> (send (S, C, 3),
    rec (B*W, 4), counts (S+1,)), all int32.  A lane's bucket is the
    folded hash masked to nseed-1, its owner bucket // (nseed/S).  A lane's
    rank is its place among the valid lanes of its owner in lane order
    p = b*W+w; a lane of rank >= C is not routed (mode="drop").  rec holds
    (slot = owner*C + rank or -1, key_lo, key_hi, valid | fwd_le<<1),
    (-1, 0, 0, 0) for an invalid window; counts the valid lanes of each
    owner, then 1 if any exceeds C."""
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


def _lane_fields(lanes, base: int, per: int):
    """(N, 3) int32 lanes (bucket, key_lo, key_hi) -> (mine, local bucket
    or 0, u32 key_lo, u32 key_hi); mine = base <= bucket < base + per (the
    fallback's owner test; every lane of a receive buffer at base 0)."""
    bkt = lanes[:, 0].long()
    mine = (bkt >= base) & (bkt < base + per)
    return mine, torch.where(mine, bkt - base, 0), u32(lanes[:, 1]), u32(lanes[:, 2])


def _mine_vals(mine, vals, wide: bool):
    """The owner's values where the lane is its own, 0 elsewhere: (N,) or
    the (N, 2) pairs."""
    if wide:
        return torch.stack([torch.where(mine, vals[0], 0), torch.where(mine, vals[1], 0)], 1)
    return torch.where(mine, vals, 0)


def owner_probe_plain(t1, seeds, lanes, *, base: int, per_seed: int, wide: bool):
    """Plain version of K12, `_displaced_local_probe` (routed.py:405-419)
    on (N, 3) int32 lanes (bucket, key_lo, key_hi) of one shard's slice:
    (N,) raw values (narrow) or (N, 2) pairs (wide).  A lane whose bucket
    lies outside [base, base + per_seed) gives 0 (the fallback's `mine`)."""
    mine, local, klo, khi = _lane_fields(lanes, base, per_seed)
    seed = displaced_seed(seeds, local)
    slot = displaced_slot(klo, khi, seed, torch.ones_like(mine), 2 * t1.shape[0])
    rows = t1[slot >> 1]
    probe = probe_rows_wide if wide else probe_rows
    return _mine_vals(mine, probe(rows, klo, khi, 2), wide)


def canonical_owner_probe_plain(t1, lanes, *, base: int, per_shard: int, wide: bool):
    """Plain version of K17, the owner side of `_routed_probe_t1`
    (routed.py:153-165) and the probe of `routed_fallback_step` (:250-266):
    for (N, 3) int32 lanes (bucket, key_lo, key_hi), probe_rows[_wide] over
    row bucket - base of one shard's t1 slice (rows of slots*3 or slots*4
    columns) -> (N,) raw values (narrow) or (N, 2) pairs (wide); 0 for a
    lane whose bucket lies outside [base, base + per_shard)."""
    mine, local, klo, khi = _lane_fields(lanes, base, per_shard)
    slots = t1.shape[1] // (4 if wide else 3)
    probe = probe_rows_wide if wide else probe_rows
    return _mine_vals(mine, probe(t1[local], klo, khi, slots), wide)


def _tail_level(val, t, bkt, key_lo, key_hi, wide: bool):
    """Where the value misses (0, or both lanes 0 wide), the value of the
    key in row `bkt` of the replicated table `t`."""
    slots = t.shape[1] // (4 if wide else 3)
    if wide:
        return _first_hit_wide(*val, probe_rows_wide(t[bkt], key_lo, key_hi, slots))
    return torch.where(val != 0, val, probe_rows(t[bkt], key_lo, key_hi, slots))


def displaced_t3_tail(val, t3, key_lo, key_hi, valid, wide: bool):
    """`_displaced_t3_tail` (routed.py:462-474): where the value misses, the
    replicated t3's (an 8-row t3 is the "absent" sentinel); `val` is the
    raw value (narrow) or the (va, vb) pair (wide); keys are u32 lanes."""
    if t3.shape[0] <= 8:
        return val
    return _tail_level(val, t3, canonical_bucket3(key_lo, key_hi, valid, t3.shape[0]),
                       key_lo, key_hi, wide)


def tail_probe_plain(val, t2, t3, bkt2, key_lo, key_hi, valid, *, wide: bool):
    """`_tail_probe` / `_tail_probe_wide` (routed.py:95-118): where the value
    misses, the replicated t2's row at `bkt2` (canonical_buckets' second
    bucket), then where it still misses t3's, as `displaced_t3_tail`; a t2
    of 8 rows is the "absent" sentinel too."""
    if t2.shape[0] > 8:
        val = _tail_level(val, t2, bkt2, key_lo, key_hi, wide)
    return displaced_t3_tail(val, t3, key_lo, key_hi, valid, wide)


def _finish_plain(rec, reply, tail, *, b: int, w: int, do_rc: bool, bad_ix: int,
                  wide: bool):
    """Each lane's value from `reply` at its record's slot (0 for slot -1),
    tail(val, key_lo, key_hi, valid) on it, the decode -> (b, 2w) ids with
    RC, else (b, w)."""
    slot = rec[:, 0].long()
    klo, khi = u32(rec[:, 1]), u32(rec[:, 2])
    valid, fwd_le = (rec[:, 3] & 1) == 1, (rec[:, 3] & 2) == 2
    has, at = slot >= 0, slot.clamp(min=0)
    vm, fm = valid.reshape(b, w), fwd_le.reshape(b, w)
    if wide:
        rep = reply.reshape(-1, 2)
        va, vb = tail((torch.where(has, rep[at, 0], 0), torch.where(has, rep[at, 1], 0)),
                      klo, khi, valid)
        r = decode_canonical_wide(va.reshape(b, w), vb.reshape(b, w), vm, fm, bad_ix, do_rc)
    else:
        val = tail(torch.where(has, reply.reshape(-1)[at], 0), klo, khi, valid)
        r = decode_canonical_vals(val.reshape(b, w), vm, fm, bad_ix, do_rc)
    return torch.cat(r, dim=1) if do_rc else r


def routed_finish_plain(rec, reply, t3, *, b: int, w: int, do_rc: bool,
                        bad_ix: int, wide: bool):
    """Plain version of K13: the reply gather, the t3 tail and the decode
    of the displaced steps (routed.py:444-459, :507-518)."""
    return _finish_plain(rec, reply,
                         lambda v, klo, khi, valid: displaced_t3_tail(v, t3, klo, khi,
                                                                      valid, wide),
                         b=b, w=w, do_rc=do_rc, bad_ix=bad_ix, wide=wide)


def routed_canonical_finish_plain(rec, reply, t2, t3, *, b: int, w: int, do_rc: bool,
                                  bad_ix: int, wide: bool):
    """Plain version of K18: the reply gather, the t2 then t3 tail and the
    decode of the canonical steps (routed.py:196-212, :254-268)."""
    def tail(v, klo, khi, valid):
        # canonical_buckets' c2 bucket; the c1 count plays no part in it
        bkt2 = canonical_buckets(klo, khi, valid, 1, t2.shape[0])[1]
        return tail_probe_plain(v, t2, t3, bkt2, klo, khi, valid, wide=wide)

    return _finish_plain(rec, reply, tail, b=b, w=w, do_rc=do_rc, bad_ix=bad_ix,
                         wide=wide)


# ---- kernel wrappers ----------------------------------------------------------

def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def route_displaced(packed, vbits, lens, *, nseed: int, num_shards: int, capacity: int):
    """K11 `route_displaced` on CUDA tensors; `route_displaced_plain` on
    CPU tensors.  The canonical steps pass nseed = b1: the same fold,
    masked to a power of two, is the canonical t1 bucket."""
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
    tiles = -(-(b * w) // 1024)
    send = torch.empty((S, C, 3), dtype=torch.int32, device=dev)
    rec = torch.empty((b * w, 4), dtype=torch.int32, device=dev)
    counts = torch.empty(S + 1, dtype=torch.int32, device=dev)
    # the look-back's flag for each (tile, owner), then the tile ticket
    scratch = torch.empty(tiles * S + 1, dtype=torch.int64, device=dev)
    kernels.launch("route_displaced", packed.data_ptr(), vbits.data_ptr(),
                   lens.data_ptr(), b, row4, row8, w, nseed, S, C, scratch.data_ptr(),
                   send.data_ptr(), rec.data_ptr(), counts.data_ptr(), _stream(dev))
    return send, rec, counts


def owner_probe(t1, seeds, lanes, *, base: int, per_seed: int, wide: bool):
    """K12 `owner_probe[_wide]` on CUDA tensors; `owner_probe_plain` on CPU
    tensors.  K12 loads a d1 row as 8 B (narrow) or 16 B (wide) vectors:
    t1 must start on that boundary."""
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
    _row_aligned(t1, "t1", 16 if wide else 8)
    n = lanes.shape[0]
    out = torch.empty((n, 2) if wide else (n,), dtype=torch.int32, device=dev)
    kernels.launch("owner_probe" + ("_wide" if wide else ""), lanes.data_ptr(), n,
                   base, per_seed, t1.data_ptr(), 2 * t1.shape[0], seeds.data_ptr(),
                   out.data_ptr(), _stream(dev))
    return out


def canonical_owner_probe(t1, lanes, *, base: int, per_shard: int, wide: bool):
    """K17 `canonical_owner_probe[_wide]` on CUDA tensors;
    `canonical_owner_probe_plain` on CPU tensors.  K17 loads a two-slot
    row as 8 B (narrow) or 16 B (wide) vectors: such a t1 must start on
    that boundary."""
    if lanes.device.type == "cpu":
        return canonical_owner_probe_plain(t1, lanes, base=base, per_shard=per_shard,
                                           wide=wide)
    dev = lanes.device
    cps = 4 if wide else 3
    kernels.require(lanes, "lanes", torch.int32, 2, dev)
    kernels.require(t1, "t1", torch.int32, 2, dev)
    if lanes.shape[1] != 3 or t1.shape[1] % cps or t1.shape[1] < cps:
        raise ValueError(f"canonical_owner_probe takes (N, 3) lanes and t1 rows of "
                         f"{cps}-column slots, got {tuple(lanes.shape)}, {tuple(t1.shape)}")
    if not 1 <= per_shard <= t1.shape[0]:
        raise ValueError(f"per_shard {per_shard} outside the slice's {t1.shape[0]} rows")
    if t1.shape[1] == 2 * cps:
        _row_aligned(t1, "t1", 16 if wide else 8)
    n = lanes.shape[0]
    out = torch.empty((n, 2) if wide else (n,), dtype=torch.int32, device=dev)
    kernels.launch("canonical_owner_probe" + ("_wide" if wide else ""), lanes.data_ptr(),
                   n, base, per_shard, t1.data_ptr(), t1.shape[1] // cps, out.data_ptr(),
                   _stream(dev))
    return out


def _check_rec(rec, b: int, w: int, dev) -> None:
    kernels.require(rec, "rec", torch.int32, 2, dev)
    if rec.shape != (b * w, 4):
        raise ValueError(f"rec {tuple(rec.shape)} is not ({b * w}, 4)")


def _tail_table(t, name: str, cps: int, dev) -> tuple[int, int]:
    """(rows, slots) of a replicated tail table, checked."""
    kernels.require(t, name, torch.int32, 2, dev)
    n = t.shape[0]
    if t.shape[1] % cps or t.shape[1] < cps or n < 1 or n & (n - 1):
        raise ValueError(f"{name} {tuple(t.shape)} is no power-of-two table of "
                         f"{cps}-column slots")
    return n, t.shape[1] // cps


def routed_finish(rec, reply, t3, *, b: int, w: int, do_rc: bool, bad_ix: int,
                  wide: bool):
    """K13 `routed_finish[_wide]` on CUDA tensors; `routed_finish_plain` on
    CPU tensors."""
    if rec.device.type == "cpu":
        return routed_finish_plain(rec, reply, t3, b=b, w=w, do_rc=do_rc,
                                   bad_ix=bad_ix, wide=wide)
    dev = rec.device
    _check_rec(rec, b, w, dev)
    kernels.require(reply, "reply", torch.int32, reply.dim(), dev)
    n3, s3 = _tail_table(t3, "t3", 4 if wide else 3, dev)
    out = torch.empty((b, 2 * w if do_rc else w), dtype=torch.int32, device=dev)
    kernels.launch("routed_finish" + ("_wide" if wide else ""), rec.data_ptr(),
                   reply.data_ptr(), b, w, t3.data_ptr(), n3, s3,
                   int(do_rc), bad_ix, out.data_ptr(), _stream(dev))
    return out


def routed_canonical_finish(rec, reply, t2, t3, *, b: int, w: int, do_rc: bool,
                            bad_ix: int, wide: bool):
    """K18 `routed_canonical_finish[_wide]` on CUDA tensors;
    `routed_canonical_finish_plain` on CPU tensors."""
    if rec.device.type == "cpu":
        return routed_canonical_finish_plain(rec, reply, t2, t3, b=b, w=w, do_rc=do_rc,
                                             bad_ix=bad_ix, wide=wide)
    dev = rec.device
    cps = 4 if wide else 3
    _check_rec(rec, b, w, dev)
    kernels.require(reply, "reply", torch.int32, reply.dim(), dev)
    n2, s2 = _tail_table(t2, "t2", cps, dev)
    n3, s3 = _tail_table(t3, "t3", cps, dev)
    out = torch.empty((b, 2 * w if do_rc else w), dtype=torch.int32, device=dev)
    kernels.launch("routed_canonical_finish" + ("_wide" if wide else ""), rec.data_ptr(),
                   reply.data_ptr(), b, w, t2.data_ptr(), n2, s2, t3.data_ptr(), n3, s3,
                   int(do_rc), bad_ix, out.data_ptr(), _stream(dev))
    return out


# ---- the steps --------------------------------------------------------------------

def _shard_rows(mesh: ShardMesh, i: int, rows: slice, *tensors):
    return [t[rows].to(mesh.devices[i], non_blocking=True) for t in tensors]


def _split(n: int, parts: int) -> int:
    if n % parts:
        raise ValueError(f"{n} rows do not divide over {parts} devices")
    return n // parts


def _routed_step(mesh: ShardMesh, S: int, nbkt: int, owner, finish, *, wide: bool,
                 num_labels: int, cap: int, capacity: int | None):
    """step(tables, packed, vbits, lens) -> one (B/(D*S), cap+2) int32 tensor
    a device, in mesh order: the rows split over all D*S devices (P(("data",
    "table"))); on each K11 at `nbkt` buckets, the all_to_all over `table`,
    owner(table, lanes, base=0) on each device, the all_to_all back,
    finish(rec, reply, table, b, w), K2, and the overflow column (the psum
    over both axes)."""
    _check_shards(mesh, S)

    def step(tables, packed, vbits, lens):
        n = mesh.size
        b_loc = _split(packed.shape[0], n)
        w = packed.shape[1] * 4 - 31
        c = capacity if capacity is not None else max(
            128, int(np.ceil(b_loc * w / S * CAPACITY_FACTOR / 128)) * 128)
        sends, recs, flags = [], [], []
        for i in range(n):
            with mesh.on(i):
                send, rec, counts = route_displaced(
                    *_shard_rows(mesh, i, slice(i * b_loc, (i + 1) * b_loc),
                                 packed, vbits, lens),
                    nseed=nbkt, num_shards=S, capacity=c)
            sends.append(send)
            recs.append(rec)
            flags.append(counts[S:])
        recv = mesh.all_to_all(sends)
        vals = []
        for i in range(n):
            with mesh.on(i):
                v = owner(tables[i], recv[i].reshape(S * c, 3), 0)
            vals.append(v.reshape((S, c, 2) if wide else (S, c)))
        reply = mesh.all_to_all(vals)
        oflo = mesh.psum(flags)  # over both axes: the same on every device
        out = []
        for i in range(n):
            with mesh.on(i):
                ids = finish(recs[i], reply[i], tables[i], b_loc, w)
                rows = histogram_packed(ids, num_labels, cap)
                out.append(torch.cat([rows, oflo[i].expand(b_loc, 1)], dim=1))
        return out

    return step


def _fallback_step(mesh: ShardMesh, S: int, nbkt: int, owner, finish, *,
                   num_labels: int, cap: int):
    """step(tables, packed, vbits, lens) -> one (B/D, cap+1) int32 tensor a
    data row, on the row's first device (d, 0): the rows split over `data`
    (P("data")); on (d, 0) K11 as one shard with room for every lane (global
    buckets); owner(table, lanes, base=s*nbkt/S) on every device (d, s) of
    the row; the sum over `table` onto (d, 0); finish and K2 there."""
    _check_shards(mesh, S)
    per = nbkt // S

    def step(tables, packed, vbits, lens):
        b = _split(packed.shape[0], mesh.shape[0])
        w = packed.shape[1] * 4 - 31
        groups = mesh.groups("table")
        vals, recs = [None] * mesh.size, []
        for d, group in enumerate(groups):
            with mesh.on(group[0]):
                lanes, rec, _ = route_displaced(
                    *_shard_rows(mesh, group[0], slice(d * b, (d + 1) * b),
                                 packed, vbits, lens),
                    nseed=nbkt, num_shards=1, capacity=max(1, b * w))
            lanes = lanes.reshape(-1, 3)
            recs.append(rec)
            for s, i in enumerate(group):
                with mesh.on(i):
                    vals[i] = owner(tables[i], lanes.to(mesh.devices[i], non_blocking=True),
                                    s * per)
        out = []
        for group, summed, rec in zip(groups, mesh.reduce(vals, "table"), recs):
            with mesh.on(group[0]):
                ids = finish(rec, summed, tables[group[0]], b, w)
                out.append(histogram_packed(ids, num_labels, cap))
        return out

    return step


def routed_displaced_search_step(mesh: ShardMesh, sharded: ShardedDisplacedIndex, *,
                                 do_rc: bool, num_labels: int, cap: int, bad_ix: int,
                                 capacity: int | None = None):
    """`routed_displaced_search_step` (routed.py:477-532) on a (D, S) mesh:
    returns step(tables, packed, vbits, lens) -> D*S tensors of (B/(D*S),
    cap+2) int32 in mesh order, each on its device: `pack_hist` rows and
    the overflow column.  `tables` is `sharded.to_devices(mesh)`; every one
    of the L-31 windows of the padded width is probed, as JAX's step does.
    The capacity of a (sender, owner) pair is JAX's, or `capacity`."""
    S, wide = sharded.num_shards, sharded.wide
    per_seed = sharded.nseed // S
    bad_ix = min(bad_ix, 0x7FFFFFFF)
    return _routed_step(
        mesh, S, sharded.nseed,
        lambda tab, lanes, base: owner_probe(tab["t1"], tab["ds"], lanes, base=base,
                                             per_seed=per_seed, wide=wide),
        lambda rec, reply, tab, b, w: routed_finish(rec, reply, tab["t3"], b=b, w=w,
                                                    do_rc=do_rc, bad_ix=bad_ix, wide=wide),
        wide=wide, num_labels=num_labels, cap=cap, capacity=capacity)


def routed_displaced_fallback_step(mesh: ShardMesh, sharded: ShardedDisplacedIndex, *,
                                   do_rc: bool, num_labels: int, cap: int, bad_ix: int):
    """`routed_displaced_fallback_step` (routed.py:535-585) on a (D, S)
    mesh: returns step(tables, packed, vbits, lens) -> D tensors of (B/D,
    cap+1) int32 `pack_hist` rows, one a data row on its device (d, 0).
    Every table shard of a row probes its own bucket range for the row's
    whole batch (K12 with base s*nseed/S) and the values sum over `table`."""
    S, wide = sharded.num_shards, sharded.wide
    per_seed = sharded.nseed // S
    bad_ix = min(bad_ix, 0x7FFFFFFF)
    return _fallback_step(
        mesh, S, sharded.nseed,
        lambda tab, lanes, base: owner_probe(tab["t1"], tab["ds"], lanes, base=base,
                                             per_seed=per_seed, wide=wide),
        lambda rec, reply, tab, b, w: routed_finish(rec, reply, tab["t3"], b=b, w=w,
                                                    do_rc=do_rc, bad_ix=bad_ix, wide=wide),
        num_labels=num_labels, cap=cap)


def _canonical_parts(sharded: ShardedCanonicalIndex, do_rc: bool, bad_ix: int):
    """The owner probe (K17) and the finish (K18) of the canonical steps."""
    per_shard, wide = sharded.b1 // sharded.num_shards, sharded.wide
    bad_ix = min(bad_ix, 0x7FFFFFFF)

    def owner(tab, lanes, base):
        return canonical_owner_probe(tab["t1"], lanes, base=base, per_shard=per_shard,
                                     wide=wide)

    def finish(rec, reply, tab, b, w):
        return routed_canonical_finish(rec, reply, tab["t2"], tab["t3"], b=b, w=w,
                                       do_rc=do_rc, bad_ix=bad_ix, wide=wide)

    return owner, finish


def routed_canonical_search_step(mesh: ShardMesh, sharded: ShardedCanonicalIndex, *,
                                 do_rc: bool, num_labels: int, cap: int, bad_ix: int,
                                 capacity: int | None = None):
    """`routed_canonical_search_step` (routed.py:170-227) on a (D, S) mesh:
    returns step(tables, packed, vbits, lens) -> D*S tensors of (B/(D*S),
    cap+2) int32 in mesh order, each on its device: the packed histograms
    of `search_step_hist_packed` and the overflow column (nonzero: dispatch
    the batch again through `routed_fallback_step`).  `tables` is
    `sharded.to_devices(mesh)`.  K11 at b1 buckets, K17, K18, K2."""
    owner, finish = _canonical_parts(sharded, do_rc, bad_ix)
    return _routed_step(mesh, sharded.num_shards, sharded.b1, owner, finish,
                        wide=sharded.wide, num_labels=num_labels, cap=cap,
                        capacity=capacity)


def routed_fallback_step(mesh: ShardMesh, sharded: ShardedCanonicalIndex, *,
                         do_rc: bool, num_labels: int, cap: int, bad_ix: int):
    """`routed_fallback_step` (routed.py:230-279) on a (D, S) mesh: returns
    step(tables, packed, vbits, lens) -> D tensors of (B/D, cap+1) int32
    `pack_hist` rows, one a data row on its device (d, 0); the routed
    step's rows without the overflow column.  K11 as one shard, K17 on
    every table shard with base s*b1/S, the sum over `table`, K18, K2."""
    owner, finish = _canonical_parts(sharded, do_rc, bad_ix)
    return _fallback_step(mesh, sharded.num_shards, sharded.b1, owner, finish,
                          num_labels=num_labels, cap=cap)
