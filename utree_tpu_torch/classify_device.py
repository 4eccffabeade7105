"""Aufbau vote on the device: counterpart of `utree_tpu/classify_device.py`.

The GG vote (itree.c:1028-1098) is a character-level walk over a read's
unique hit labels sorted by taxonomy string.  Its character probes depend
only on the label strings, so `build_aufbau_tables` (numpy, the port's copy
of the JAX package's builder) precomputes per label: string-sort ranks, a
range-min sparse table over adjacent-rank LCPs, ';' / '_' bitmasks, sorted
';' positions and lengths.  This module moves them to a device and runs the
walk:

  vote_rows  -> K3 `csrc/aufbau.cu` (plain: aufbau_walk + pack_vote), on
                the tables `VoteTables` checks once where they are placed

`aufbau_walk` mirrors `aufbau_walk_device` step for step: the batch-wide
loop, the masks, the u32 wraparound counters (int64 lanes masked to 32
bits) and JAX's gather index semantics, including on lanes whose indices
point at padding.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from utree_tpu_torch import kernels
from utree_tpu_torch._u32 import M, floor_log2, i32, jax_index, u32

_U32_M1 = 0xFFFFFFFF
_U32_M2 = 0xFFFFFFFE
VOTE_TABLE_KEYS = ("rank", "st", "slen", "semi", "und", "spos")

# dv sentinel codes returned in the packed result
DV_INTERP = 0   # toprint = rep string cut at dv chars
DV_EMPTY = 1    # dv == (uint32)-1: toprint = ""
DV_FULL = 2     # dv == (uint32)-2: toprint = full rep string


@dataclasses.dataclass
class AufbauTables:
    """Per-label integer metadata for the device walk (host numpy)."""

    rank_of_label: np.ndarray  # (L,) int32: position in string-sorted order
    st_tab: np.ndarray  # (nlev, L) int32 range-min sparse table over adj lcps
    slen: np.ndarray  # (L,) int32
    semi_mask: np.ndarray  # (L, W) uint32, bit p%32 of word p//32 = ';' at p
    und_mask: np.ndarray  # (L, W) uint32, same for '_'
    semi_pos: np.ndarray  # (L, R) int32 sorted ';' positions, pad = BIG
    max_len: int

    BIG = np.int32(0x3FFFFFFF)


def build_aufbau_tables(strings: list[bytes]) -> AufbauTables:
    """The walk's per-label tables for `strings` (label id order)."""
    L = len(strings)
    order = sorted(range(L), key=lambda i: strings[i])
    rank_of_label = np.zeros(L, np.int32)
    for r, i in enumerate(order):
        rank_of_label[i] = r
    max_len = max((len(s) for s in strings), default=0)
    # adjacent-rank LCPs
    adj = np.zeros(max(L, 1), np.int32)
    for r in range(1, L):
        a, b = strings[order[r - 1]], strings[order[r]]
        m = min(len(a), len(b))
        p = 0
        while p < m and a[p] == b[p]:
            p += 1
        adj[r] = p
    nlev = max(1, int(np.ceil(np.log2(max(L, 2)))) + 1)
    st_tab = np.zeros((nlev, max(L, 1)), np.int32)
    st_tab[0] = adj
    for j in range(1, nlev):
        h = 1 << (j - 1)
        shifted = np.minimum(np.arange(max(L, 1)) + h, max(L, 1) - 1)
        st_tab[j] = np.minimum(st_tab[j - 1], st_tab[j - 1][shifted])
    slen = np.array([len(s) for s in strings], np.int32).reshape(L)
    W = max(1, (max_len + 31) // 32)
    semi_mask = np.zeros((L, W), np.uint32)
    und_mask = np.zeros((L, W), np.uint32)
    max_semis = 1
    for i, s in enumerate(strings):
        for p, ch in enumerate(s):
            if ch == 0x3B:
                semi_mask[i, p // 32] |= np.uint32(1) << np.uint32(p % 32)
            elif ch == 0x5F:
                und_mask[i, p // 32] |= np.uint32(1) << np.uint32(p % 32)
        max_semis = max(max_semis, s.count(b";"))
    R = max_semis + 1
    semi_pos = np.full((L, R), int(AufbauTables.BIG), np.int32)
    for i, s in enumerate(strings):
        k = 0
        for p, ch in enumerate(s):
            if ch == 0x3B:
                semi_pos[i, k] = p
                k += 1
    return AufbauTables(rank_of_label, st_tab, slen, semi_mask, und_mask,
                        semi_pos, max_len)


def aufbau_tables_to_device(tab: AufbauTables, device) -> dict[str, torch.Tensor]:
    """The walk's tables as int32 tensors on `device`, under the keys of the
    JAX package's `AufbauTables.device_put`.  The u32 bitmasks travel as their int32 bits."""
    return {
        "rank": torch.from_numpy(tab.rank_of_label).to(device),
        "st": torch.from_numpy(tab.st_tab).to(device),
        "slen": torch.from_numpy(tab.slen).to(device),
        "semi": torch.from_numpy(tab.semi_mask.view("int32")).to(device),
        "und": torch.from_numpy(tab.und_mask.view("int32")).to(device),
        "spos": torch.from_numpy(tab.semi_pos).to(device),
    }


def _signed(p: torch.Tensor) -> torch.Tensor:
    """A u32 lane's int32 value (JAX's astype(int32)), kept in int64."""
    return torch.where(p >= (1 << 31), p - (1 << 32), p)


def aufbau_walk(tab: dict, labels, counts, nuniq, found, *, taxacut: int,
                max_iters: int):
    """Plain version of the walk (`aufbau_walk_device`).  labels/counts (B, C)
    int32 compact histograms, nuniq/found (B,) int32.  Returns int32
    (rep, dvcode, dv, sl, ol, flag), each (B,)."""
    I64 = torch.int64
    B, C = labels.shape
    BIG = int(AufbauTables.BIG)
    labels = labels.to(I64)
    nuniq = nuniq.to(I64)
    found = found.to(I64)
    rank_t = tab["rank"].to(I64)
    slen = tab["slen"].to(I64)
    spos = tab["spos"].to(I64)
    stt = tab["st"].to(I64)
    semi = u32(tab["semi"])
    und = u32(tab["und"])
    nlev, lst = stt.shape

    rank = torch.where(labels >= 0,
                       rank_t[jax_index(labels.clamp(min=0), rank_t.shape[0])], BIG)
    order = torch.argsort(rank, dim=1, stable=True)
    ent_lab = labels.gather(1, order)
    ent_cnt = u32(counts.to(I64).gather(1, order))
    ent_rank = rank.gather(1, order)

    def ent(mat, idx):
        return mat.gather(1, idx.clamp(0, C - 1)[:, None])[:, 0]

    def char0(lab, p):
        return p >= slen[jax_index(lab, slen.shape[0])]

    def bit_at(mask, lab, p):
        pi = _signed(p)
        w = mask[jax_index(lab, mask.shape[0]), (pi >> 5).clamp(0, mask.shape[1] - 1)]
        return (~char0(lab, p)) & (((w >> (pi & 31)) & 1) == 1)

    def next_semi(lab, p):
        ps = spos[jax_index(lab, spos.shape[0])]
        cand = torch.where(ps >= _signed(p)[:, None], ps, BIG)
        return cand.min(dim=1).values & M

    def lcp(ra, rb):
        m = floor_log2((rb - ra).clamp(min=1))
        mi = m.clamp(0, nlev - 1)
        lo = stt[mi, jax_index(ra + 1, lst)]
        hi = stt[mi, jax_index((rb - (torch.ones_like(m) << m) + 1).clamp(min=0), lst)]
        return torch.minimum(lo, hi) & M

    def cut(x):
        c = (x - x // taxacut) & M
        return (c + ((x >> 1) >= c).to(I64)) & M

    found_u = found & M
    uix = torch.clamp(nuniq, max=C)
    walk = (nuniq >= 2) & (nuniq <= C) & (found >= 2)
    over = nuniq > C

    st = torch.zeros(B, dtype=I64, device=labels.device)
    ed = uix.clone()
    dv = torch.full_like(st, _U32_M1)
    orun = found_u.clone()
    cutoff = cut(found_u)
    run = ent_cnt[:, 0].clone()
    td = dv.clone()
    z = torch.ones_like(st)
    sl = torch.zeros_like(st)
    ol = torch.zeros_like(st)
    done = ~walk
    it = 0
    while bool((~done).any()) and it < max_iters:
        act = ~done
        in_inner = act & (z < ed)
        # ---- inner step (itree.c:1048-1079) ----
        lab1, cnt1 = ent(ent_lab, z - 1), ent(ent_cnt, z - 1)
        lab2, cnt2 = ent(ent_lab, z), ent(ent_cnt, z)
        r1, r2 = ent(ent_rank, z - 1), ent(ent_rank, z)
        probe = torch.where(dv == _U32_M1, 0, dv)
        case0 = char0(lab1, probe)
        l12 = lcp(r1, r2)
        stop = torch.minimum(slen[jax_index(lab1, slen.shape[0])], l12)
        tdn = torch.minimum(next_semi(lab1, (dv + 1) & M), stop)
        c_eq = tdn < l12
        c1_0 = char0(lab1, tdn)
        c1_semi = bit_at(semi, lab1, tdn)
        c2_semi = bit_at(semi, lab2, tdn)
        c1_und = (tdn >= 1) & bit_at(und, lab1, (tdn - 1) & M)
        promo = (c1_0 & c2_semi) | ((c1_semi | c1_0) & c1_und)
        case1 = ~case0 & c_eq
        case2 = ~case0 & ~c_eq & promo
        case3 = ~case0 & ~c_eq & ~promo & (run >= cutoff)
        case4 = ~case0 & ~c_eq & ~promo & (run < cutoff)
        drop = in_inner & (case0 | case2)
        n_run = torch.where(case1, (run + cnt2) & M,
                            torch.where(case0 | case2 | case4, cnt2, run))
        n_orun = torch.where(drop, (orun - cnt1) & M, orun)
        n_cut = torch.where(drop, cut(n_orun), cutoff)
        n_st = torch.where(in_inner & (case0 | case2 | case4), z, st)
        td = torch.where(in_inner & ~case0, tdn, td)
        ed = torch.where(in_inner & case3, z, ed)
        z = torch.where(in_inner & ~case3, z + 1, z)
        run = torch.where(in_inner, n_run, run)
        orun = torch.where(in_inner, n_orun, orun)
        cutoff = torch.where(in_inner, n_cut, cutoff)
        st = torch.where(in_inner, n_st, st)
        # ---- after the inner loop (itree.c:1080-1096) ----
        after = act & (z >= ed)
        sl = torch.where(after, run, sl)
        ol = torch.where(after, orun, ol)
        exit1 = after & (run < cutoff)
        single = after & ~exit1 & (st + 1 >= ed)
        dv = torch.where(single & (ent(ent_cnt, ed - 1) >= cutoff), _U32_M2, dv)
        descend = after & ~exit1 & ~single
        orun = torch.where(descend, run, orun)
        dv = torch.where(descend, td, dv)
        cutoff = torch.where(descend, cut(run), cutoff)
        run = torch.where(descend, ent(ent_cnt, st), run)
        td = torch.where(descend, dv, td)
        z = torch.where(descend, st + 1, z)
        done = done | exit1 | single
        it += 1

    hit_cap = walk & ~done  # defensive: never expected, host replays
    rep = ent(ent_lab, ed - 1)
    dvcode = torch.where(dv == _U32_M1, DV_EMPTY,
                         torch.where(dv == _U32_M2, DV_FULL, DV_INTERP))
    triv = nuniq <= 1
    rep = torch.where(triv, labels[:, 0], rep)
    dvcode = torch.where(triv, DV_FULL, dvcode)
    flag = (over | hit_cap).to(torch.int32)
    return (rep.to(torch.int32), dvcode.to(torch.int32), i32(dv), i32(sl),
            i32(ol), flag)


def pack_vote(rep, dvcode, dv, sl, ol, flag, nuniq, found) -> torch.Tensor:
    """The 12 B/read rows of `search_step_vote_compact` (lookup.py:798-808),
    (B, 3) int32:
      w0 = (rep+1) | min(nuniq,31)<<17 | dvcode<<22 | flag<<24
      w1 = found | dv<<20 (dv only for DV_INTERP)
      w2 = sl | ol<<16
    A read whose fields overflow their lanes is flagged for the host replay."""
    I64 = torch.int64
    rep, dvcode, dv, sl, ol, flag, nuniq, found = (
        x.to(I64) for x in (rep, dvcode, dv, sl, ol, flag, nuniq, found))
    unfit = ((found >= (1 << 20)) | (sl >= (1 << 16)) | (ol >= (1 << 16))
             | ((dvcode == DV_INTERP) & (dv >= (1 << 11))))
    flag = flag | unfit.to(I64)
    w0 = (((rep + 1) & M) | (torch.clamp(nuniq, max=31) << 17)
          | (dvcode << 22) | (flag << 24))
    w1 = (found & M) | (((torch.where(dvcode == DV_INTERP, dv, 0) & M) << 20) & M)
    w2 = (sl & M) | (((ol & M) << 16) & M)
    return i32(torch.stack([w0, w1, w2], dim=1))


class VoteTables:
    """The vote tables of one device, checked once where they are placed:
    what K3 reads past the histograms.  `tab` maps VOTE_TABLE_KEYS to int32
    tensors of one device, as `aufbau_tables_to_device` places them; a
    table of another type, rank or device, or of a shape that disagrees
    with `rank`'s label count, raises ValueError.  On a card the tables'
    pointers and shapes are bound here, for every call."""

    def __init__(self, tab: dict):
        self.tab = {k: tab[k] for k in VOTE_TABLE_KEYS}
        t = self.tab
        self.device = t["rank"].device
        for k, nd in zip(VOTE_TABLE_KEYS, (1, 2, 1, 2, 2, 2)):
            kernels.require(t[k], k, torch.int32, nd, self.device)
        L = t["rank"].shape[0]
        if (t["st"].shape[1] != L or t["slen"].shape != (L,) or t["semi"].shape[0] != L
                or t["und"].shape != t["semi"].shape or t["spos"].shape[0] != L):
            raise ValueError("vote tables have inconsistent shapes")
        self.arg = None
        if self.device.type == "cuda":
            from utree_tpu_torch.kernels.build import VoteTablesArg

            self._struct = VoteTablesArg(
                t["rank"].data_ptr(), t["st"].data_ptr(), t["st"].shape[0], L,
                t["slen"].data_ptr(), t["semi"].data_ptr(), t["und"].data_ptr(),
                t["semi"].shape[1], t["spos"].data_ptr(), t["spos"].shape[1])
            self.arg = ctypes.addressof(self._struct)

    @classmethod
    def from_table(cls, table: dict) -> "VoteTables":
        """The `vt_*` entries of a device table (search_step_vote_compact's)."""
        return cls({k: table["vt_" + k] for k in VOTE_TABLE_KEYS})


def vote_rows(tab, labels, counts, nuniq, found, *, taxacut: int,
              max_iters: int) -> torch.Tensor:
    """K3 `aufbau_vote` on CUDA tensors; the plain walk + pack on CPU ones.
    `tab` is a `VoteTables` or a dict of the tables (checked each call)."""
    if labels.device.type == "cpu":
        walked = aufbau_walk(tab.tab if isinstance(tab, VoteTables) else tab,
                             labels, counts, nuniq, found,
                             taxacut=taxacut, max_iters=max_iters)
        return pack_vote(*walked, nuniq, found)
    vt = tab if isinstance(tab, VoteTables) else VoteTables(tab)
    dev = vt.device
    B, C = labels.shape
    if not 1 <= C <= 30:
        raise ValueError(f"histogram width {C} out of range 1..30")
    for name, t, nd in (("labels", labels, 2), ("counts", counts, 2),
                        ("nuniq", nuniq, 1), ("found", found, 1)):
        kernels.require(t, name, torch.int32, nd, dev)
    if counts.shape != labels.shape or nuniq.shape != (B,) or found.shape != (B,):
        raise ValueError("vote inputs have inconsistent shapes")
    out = torch.empty((B, 3), dtype=torch.int32, device=dev)
    kernels.launch("aufbau_vote", labels.data_ptr(), counts.data_ptr(), nuniq.data_ptr(),
                   found.data_ptr(), B, C, vt.arg, taxacut, max_iters, out.data_ptr(),
                   kernels.stream(dev))
    return out
