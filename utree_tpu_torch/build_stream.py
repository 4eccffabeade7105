"""Out-of-core database build: reference-scale inputs at bounded RAM (the
port's copy of `utree_tpu/build_stream.py`).

The in-memory build (build.build_database) concatenates every sampled word
before one global sort: at the reference's flagship scale (5,000-genome
RefSeq, ~1e9 sampled k-mers, README.md:2) that is tens of GB of peak RAM.
This driver produces the identical result with a radix-spill pipeline:

  pass 1  stream the FASTA once; per ~chunk_words sampled words, partition
          by the top `partition_bits` of the word and append (word, prov_ix)
          runs to one spill file per partition (sequential I/O only);
  pass 2  per partition (ascending = ascending word order): load, sort,
          group; non-conflicted groups resolve immediately; conflicted words
          (>= 2 distinct labels) are collected globally: in practice a tiny
          fraction;
  pass 3  only if conflicts exist: re-stream the FASTA replaying the
          reference's insertion-order fold (xeTreeU_RF, itree.c:268-307) for
          conflicted words, allocating truncated-label ids at exactly the
          reference's moments (addSampleUd, itree.c:299);
  pass 4  per partition again: emit surviving (word, ix) records straight
          into the .ubt (ascending), tallying label counts; patch numNodes
          at offset 24 like the reference (itree.c:1317-1343).

Peak RAM = one partition + the conflicted-word set, independent of DB size.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
import struct
import tempfile

import numpy as np

from utree_tpu_torch.build import _word_key
from utree_tpu_torch.config import UTreeConfig
from utree_tpu_torch.encode import W128, sample_build_kmers, word_sort_key
from utree_tpu_torch.formats import _words_le_bytes, label_lines
from utree_tpu_torch.io.fasta import iter_fasta_records
from utree_tpu_torch.io.maps import read_tax_map
from utree_tpu_torch.taxonomy import BAD, LabelTable, fold_labels


@dataclasses.dataclass
class StreamBuildStats:
    num_seqs: int
    num_nodes: int
    num_conflicted: int
    num_labels: int
    labels: LabelTable


def _spill_dtype(k: int) -> np.dtype:
    if k > 32:
        return np.dtype([("hi", "<u8"), ("lo", "<u8"), ("prov", "<i4")])
    return np.dtype([("w", "<u8"), ("prov", "<i4")])


def build_database_streaming(
    fasta_path: str,
    map_path: str,
    config: UTreeConfig = UTreeConfig(),
    out_ubt: str | None = None,
    *,
    do_gg: bool = True,
    chunk_words: int = 1 << 25,
    partition_bits: int = 6,
    workdir: str | None = None,
) -> StreamBuildStats:
    """Stream-build `fasta_path` into `out_ubt` (byte-identical to
    build_database + write_ubt).  Peak RAM ~ max-partition size."""
    tax_map = read_tax_map(map_path)
    k, lv, cc = config.packsize, config.complevel, config.critical_cutoff
    nparts = 1 << partition_bits
    sdt = _spill_dtype(k)

    tmp = tempfile.mkdtemp(prefix="utree_build_", dir=workdir)
    spill_paths = [pathlib.Path(tmp) / f"part{p:03d}.bin" for p in range(nparts)]
    spill_files = [open(p, "wb", buffering=1 << 20) for p in spill_paths]

    prov = LabelTable()
    num_seqs = 0
    try:
        # ---- pass 1: sample + partitioned spill ----------------------------
        buf = np.empty(chunk_words + (1 << 22), dtype=sdt)
        fill = 0

        def flush_buf():
            nonlocal fill
            if not fill:
                return
            chunk = buf[:fill]
            if k > 32:
                parts = (chunk["hi"] >> np.uint64(64 - partition_bits)).astype(np.int64)
            else:
                parts = (chunk["w"] >> np.uint64(config.word_bits - partition_bits)).astype(np.int64)
            order = np.argsort(parts, kind="stable")
            sp = parts[order]
            sc = chunk[order]
            bounds = np.searchsorted(sp, np.arange(nparts + 1))
            for p in range(nparts):
                a, b = bounds[p], bounds[p + 1]
                if b > a:
                    spill_files[p].write(sc[a:b].tobytes())
            fill = 0

        for header, seq in iter_fasta_records(fasta_path):
            label = tax_map.get(header)
            if label is None:
                raise ValueError(f"taxon map incomplete: no entry for {header!r}")
            pid = prov.get_or_add(label)
            num_seqs += 1
            w = sample_build_kmers(seq, k, lv)
            pos = 0
            while pos < len(w):
                take = min(len(w) - pos, len(buf) - fill)
                seg = buf[fill : fill + take]
                if k > 32:
                    seg["hi"] = w["hi"][pos : pos + take]
                    seg["lo"] = w["lo"][pos : pos + take]
                else:
                    seg["w"] = np.asarray(w[pos : pos + take], np.uint64)
                seg["prov"] = pid
                fill += take
                pos += take
                if fill >= chunk_words:
                    flush_buf()
        flush_buf()
        del buf
        for f in spill_files:
            f.close()
        if num_seqs == 0:
            raise ValueError("no sequences in input FASTA")

        # ---- pass 2: per-partition sort; find conflicted words -------------
        conflicted_chunks: list[np.ndarray] = []
        any_words = False
        for p in range(nparts):
            rec = np.fromfile(spill_paths[p], dtype=sdt)
            if len(rec) == 0:
                continue
            any_words = True
            if k <= 32:
                words = rec["w"]
            else:
                words = np.empty(len(rec), dtype=W128)
                words["hi"] = rec["hi"]
                words["lo"] = rec["lo"]
            order = word_sort_key(words)
            sw = words[order]
            sp_ = rec["prov"][order]
            new_group = np.empty(len(sw), dtype=bool)
            new_group[0] = True
            new_group[1:] = sw[1:] != sw[:-1]
            starts = np.flatnonzero(new_group)
            gmin = np.minimum.reduceat(sp_, starts)
            gmax = np.maximum.reduceat(sp_, starts)
            cmask = gmin != gmax
            if cmask.any():
                conflicted_chunks.append(np.asarray(sw[starts[cmask]]))
            del rec, words, sw, sp_
        if not any_words:
            raise ValueError("no k-mers sampled: bad input/params")
        conflicted_words = (
            np.concatenate(conflicted_chunks) if conflicted_chunks
            else np.zeros(0, dtype=W128 if k > 32 else np.uint64)
        )

        # ---- pass 3: fold replay in global insertion order -----------------
        final = LabelTable()
        node_state: dict = {}
        if len(conflicted_words) and do_gg:
            # searchsorted needs a scalar-comparable key; W128 words convert
            # to big-endian 16-byte strings (lexicographic == numeric order)
            cw_key = conflicted_words if k <= 32 else _be_bytes128(conflicted_words)
            for header, seq in iter_fasta_records(fasta_path):
                label = tax_map[header]
                final.get_or_add(label)
                w = sample_build_kmers(seq, k, lv)
                if len(w) == 0:
                    continue
                wk = w if k <= 32 else _be_bytes128(w)
                pos = np.searchsorted(cw_key, wk)
                hit = (pos < len(cw_key)) & (
                    cw_key[np.minimum(pos, len(cw_key) - 1)] == wk
                )
                for wv in w[hit]:
                    wi = _word_key(wv)
                    state = node_state.get(wi)
                    if state is None:
                        node_state[wi] = label
                    elif state is BAD or state == label:
                        pass
                    else:
                        folded = fold_labels(state, label, cc)
                        if folded is None:
                            node_state[wi] = BAD
                        else:
                            final.get_or_add(folded)
                            node_state[wi] = folded
        else:
            final = prov  # no folds: first-appearance order is identical

        prov_to_final = np.array(
            [final.get_or_add(s) for s in prov.strings], dtype=np.int64
        )

        # ---- pass 4: emit .ubt records partition by partition --------------
        num_labels = len(final)
        label_counts = np.zeros(num_labels, dtype=np.int64)
        num_nodes = 0
        num_conflicted = 0
        wb, ib = config.wtype_bytes, config.ixtype_bytes
        out_path = out_ubt or os.path.join(tmp, "out.ubt")
        with open(out_path, "wb", buffering=1 << 20) as of:
            of.write(struct.pack("<4Q", wb, 0, ib, 0))  # numNodes patched below
            for p in range(nparts):
                rec = np.fromfile(spill_paths[p], dtype=sdt)
                spill_paths[p].unlink()  # free disk as we go
                if len(rec) == 0:
                    continue
                if k <= 32:
                    words = rec["w"]
                else:
                    words = np.empty(len(rec), dtype=W128)
                    words["hi"] = rec["hi"]
                    words["lo"] = rec["lo"]
                order = word_sort_key(words)
                sw = words[order]
                sp_ = rec["prov"][order]
                new_group = np.empty(len(sw), dtype=bool)
                new_group[0] = True
                new_group[1:] = sw[1:] != sw[:-1]
                starts = np.flatnonzero(new_group)
                uniq = sw[starts]
                out_ix = prov_to_final[sp_[starts]]
                gmin = np.minimum.reduceat(sp_, starts)
                gmax = np.maximum.reduceat(sp_, starts)
                cmask = gmin != gmax
                keep = np.ones(len(uniq), dtype=bool)
                if cmask.any():
                    num_conflicted += int(cmask.sum())
                    if not do_gg:
                        keep[cmask] = False
                    else:
                        for gi in np.flatnonzero(cmask):
                            state = node_state[_word_key(uniq[gi])]
                            if state is BAD:
                                keep[gi] = False
                            else:
                                out_ix[gi] = final.get(state)
                ukeep = uniq[keep]
                ixkeep = out_ix[keep]
                n = len(ukeep)
                if n:
                    recs = np.zeros((n, wb + ib), np.uint8)
                    recs[:, :wb] = _words_le_bytes(ukeep, wb)
                    recs[:, wb:] = (
                        np.asarray(ixkeep, dtype=f"<u{ib}").view(np.uint8).reshape(n, ib)
                    )
                    of.write(recs.tobytes())
                    label_counts += np.bincount(ixkeep, minlength=num_labels)
                    num_nodes += n
                del rec, words, sw, sp_
            of.write(label_lines(final.strings, label_counts))
            of.seek(24)
            of.write(struct.pack("<Q", num_nodes))
        return StreamBuildStats(
            num_seqs=num_seqs,
            num_nodes=num_nodes,
            num_conflicted=num_conflicted,
            num_labels=num_labels,
            labels=final,
        )
    finally:
        for f in spill_files:
            if not f.closed:
                f.close()
        for p in spill_paths:
            if p.exists():
                p.unlink()
        try:
            os.rmdir(tmp)
        except OSError:
            pass


def write_ctr_streaming(ubt_path: str, ctr_path: str,
                        config: UTreeConfig = UTreeConfig(),
                        chunk_records: int = 1 << 24) -> None:
    """utree-compress for DBs too big to hold in RAM: streams the sorted .ubt
    record dump twice (bin table, then truncated records), byte-identical to
    formats.write_ctr_from_ubt (XT_cmp32 semantics incl. bin quirks)."""
    wb, ib = config.wtype_bytes, config.ixtype_bytes
    if config.ctr_suffix_bytes < 1:
        raise ValueError("PACKSIZE < 16 DBs cannot be compressed")
    rec_sz = wb + ib
    with open(ubt_path, "rb") as fp:
        wsz, csz, isz, n = struct.unpack("<4Q", fp.read(32))
        if wsz != wb or csz != 0 or isz != ib:
            raise ValueError("DB header does not match config")
        pbits = config.ctr_prefix_bits
        shift = config.word_bits - pbits
        num_bins = config.ctr_num_bins
        # ---- scan 1: first-record index per populated prefix + quirk replay
        bin_ix = np.zeros(num_bins, dtype=np.int64)
        first_bin = -1
        first_count = 0
        done = 0
        prev_prefix = -1
        while done < n:
            m = min(chunk_records, n - done)
            raw = np.frombuffer(fp.read(m * rec_sz), np.uint8).reshape(m, rec_sz)
            words = _chunk_words(raw, wb, config)
            prefixes = _chunk_prefixes(words, config, shift)
            newm = np.empty(m, dtype=bool)
            newm[0] = prefixes[0] != prev_prefix
            newm[1:] = prefixes[1:] != prefixes[:-1]
            starts = np.flatnonzero(newm)
            bin_ix[prefixes[starts]] = starts + done
            if first_bin < 0:
                first_bin = int(prefixes[0])
            if first_count == done:  # still inside the very first prefix run
                first_count += int(np.searchsorted(prefixes, first_bin,
                                                   side="right"))
            prev_prefix = int(prefixes[-1])
            done += m
        if n:
            bin_ix[first_bin] = 1 if first_count >= 2 else 0
        bin_ix[num_bins - 1] = n
        u = int(np.argmax(bin_ix != 0))
        bin_ix[u] = 0
        tail = bin_ix[u + 1 :].copy()
        filled = np.where(tail == 0, np.int64(np.iinfo(np.int64).max), tail)
        filled = np.minimum.accumulate(filled[::-1])[::-1]
        bin_ix[u + 1 :] = filled
        # ---- scan 2: write header + bins + truncated records + labels ------
        off_dtype = "<u4" if n < 0xFFFFFFFF else "<u8"
        sfx_b = config.ctr_suffix_bytes
        with open(ctr_path, "wb", buffering=1 << 20) as of:
            of.write(struct.pack("<4Q", wb, 0, ib, n))
            of.write(bin_ix.astype(off_dtype).tobytes())
            fp.seek(32)
            remaining = n
            while remaining:
                m = min(chunk_records, remaining)
                raw = np.frombuffer(fp.read(m * rec_sz), np.uint8).reshape(m, rec_sz)
                out = np.empty((m, sfx_b + ib), np.uint8)
                out[:, :sfx_b] = raw[:, :sfx_b]
                out[:, sfx_b:] = raw[:, wb:]
                of.write(out.tobytes())
                remaining -= m
            while True:
                tail_b = fp.read(1 << 20)
                if not tail_b:
                    break
                of.write(tail_b)


def _chunk_words(raw: np.ndarray, wb: int, config: UTreeConfig):
    m = len(raw)
    if wb == 16:
        words = np.zeros(m, dtype=W128)
        words["lo"] = raw[:, :8].copy().view("<u8").reshape(m)
        words["hi"] = raw[:, 8:16].copy().view("<u8").reshape(m)
        return words
    pad = np.zeros((m, 8), np.uint8)
    pad[:, :wb] = raw[:, :wb]
    return pad.view("<u8").reshape(m)


def _chunk_prefixes(words, config: UTreeConfig, shift: int) -> np.ndarray:
    if words.dtype == W128:
        return (words["hi"] >> np.uint64(shift - 64)).astype(np.int64)
    return (np.asarray(words, np.uint64) >> np.uint64(shift)).astype(np.int64)


def _be_bytes128(words: np.ndarray) -> np.ndarray:
    """W128 -> |S16 big-endian keys whose lexicographic order equals the
    numeric (hi, lo) order, so np.searchsorted works on 128-bit words."""
    n = len(words)
    out = np.empty((n, 16), np.uint8)
    out[:, :8] = words["hi"].astype(">u8").view(np.uint8).reshape(n, 8)
    out[:, 8:] = words["lo"].astype(">u8").view(np.uint8).reshape(n, 8)
    return out.reshape(-1).view("S16")
