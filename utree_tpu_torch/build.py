"""Sort-based database build (the port's copy of `utree_tpu/build.py`).

The reference build (UT_parseSampFastaExternOSFA + UT_addWordIxRF,
itree.c:501-635, 457-473) streams one k-mer at a time into 2^24 binary search
trees and resolves label conflicts *in insertion order* with an
order-dependent fold (xeTreeU_RF, itree.c:268-307).  Pointer-chasing BSTs are
the opposite of what any vector machine wants, so this build is sort-based:

  1. sample every (word, provisional-label, position) with vectorized NumPy;
  2. one stable sort by word groups all insertions of a word while keeping
     them in insertion order;
  3. groups whose labels all agree (the overwhelming majority) are done; only
     *conflicted* words replay the reference's fold, in global insertion
     order, so that truncated-label ids are allocated at exactly the same
     moments as the reference's addSampleUd (itree.c:299) and the final id
     numbering matches bit-for-bit.

The result is the exact node/label set of the reference build, without ever
building a tree.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from utree_tpu_torch.config import UTreeConfig
from utree_tpu_torch.encode import sample_build_kmers, word_sort_key
from utree_tpu_torch.io.fasta import iter_fasta_records
from utree_tpu_torch.io.maps import read_tax_map
from utree_tpu_torch.taxonomy import BAD, LabelTable, fold_labels


def _word_key(w):
    """Hashable key for a word scalar (int for u64, bytes for W128 records)."""
    try:
        return int(w)
    except (TypeError, ValueError):
        return w.tobytes()


@dataclasses.dataclass
class BuildResult:
    """Surviving k-mer nodes, sorted ascending by word, plus the label table."""

    words: np.ndarray  # uint64, ascending, BAD nodes dropped
    ixs: np.ndarray  # int64 label ids parallel to words
    labels: LabelTable  # every label ever created (dead ones included)
    num_seqs: int
    num_conflicted: int

    @property
    def label_counts(self) -> np.ndarray:
        """Per-label surviving-node counts (traceTreeBUf tally, itree.c:408-417)."""
        return np.bincount(self.ixs, minlength=len(self.labels)).astype(np.uint64)


def build_database(
    fasta_path: str, map_path: str, config: UTreeConfig = UTreeConfig(),
    do_gg: bool = True,
) -> BuildResult:
    """do_gg=True: rank-flexible fold build (utree-buildGG).  do_gg=False:
    rank-specific build (utree-build, xeTreeU itree.c:242-266): any label
    conflict poisons the k-mer outright, so conflicted words simply drop."""
    tax_map = read_tax_map(map_path)
    k, lv, cc = config.packsize, config.complevel, config.critical_cutoff

    # ---- pass 1: vectorized sampling with provisional label ids ------------
    prov = LabelTable()
    rec_words: list[np.ndarray] = []
    rec_labels: list[bytes] = []
    for header, seq in iter_fasta_records(fasta_path):
        label = tax_map.get(header)
        if label is None:
            raise ValueError(f"taxon map incomplete: no entry for {header!r}")
        prov.get_or_add(label)
        rec_labels.append(label)
        rec_words.append(sample_build_kmers(seq, k, lv))
    if not rec_words:
        raise ValueError("no sequences in input FASTA")
    num_seqs = len(rec_words)

    words = np.concatenate(rec_words)
    if len(words) == 0:
        raise ValueError("no k-mers sampled: bad input/params")
    pix = np.concatenate(
        [np.full(len(w), prov.get_or_add(lbl), dtype=np.int64) for w, lbl in zip(rec_words, rec_labels)]
    )

    # ---- identify conflicted words (>=2 distinct labels) --------------------
    order = word_sort_key(words)
    sw = words[order]
    sp = pix[order]
    new_group = np.empty(len(sw), dtype=bool)
    new_group[0] = True
    new_group[1:] = sw[1:] != sw[:-1]
    starts = np.flatnonzero(new_group)
    ends = np.append(starts[1:], len(sw))
    gmin = np.minimum.reduceat(sp, starts)
    gmax = np.maximum.reduceat(sp, starts)
    conflicted_mask = gmin != gmax
    conflicted_words = sw[starts[conflicted_mask]]  # ascending, unique

    # ---- final pass: replay record-label creation + folds in global order ---
    final = LabelTable()
    node_state: dict[int, bytes | int] = {}
    for rwords, label in zip(rec_words, rec_labels):
        final.get_or_add(label)  # addSampleU per record, itree.c:593
        if len(rwords) == 0 or len(conflicted_words) == 0 or not do_gg:
            continue
        pos = np.searchsorted(conflicted_words, rwords)
        hit = (pos < len(conflicted_words)) & (
            conflicted_words[np.minimum(pos, len(conflicted_words) - 1)] == rwords
        )
        for w in rwords[hit]:
            wi = _word_key(w)
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
                    final.get_or_add(folded)  # addSampleUd, itree.c:299
                    node_state[wi] = folded

    # ---- assemble surviving nodes -------------------------------------------
    uniq_words = sw[starts]
    prov_to_final = np.array([final.get_or_add(s) for s in prov.strings], dtype=np.int64)
    out_ix = prov_to_final[sp[starts]]  # correct for non-conflicted groups
    keep = np.ones(len(uniq_words), dtype=bool)
    if len(conflicted_words) and not do_gg:
        # rank-specific build: every conflicted word went BAD (itree.c:260-264)
        keep[conflicted_mask] = False
    elif len(conflicted_words):
        cpos = np.flatnonzero(conflicted_mask)
        for gi in cpos:
            state = node_state[_word_key(uniq_words[gi])]
            if state is BAD:
                keep[gi] = False
            else:
                fx = final.get(state)
                assert fx is not None
                out_ix[gi] = fx

    return BuildResult(
        words=uniq_words[keep],
        ixs=out_ix[keep],
        labels=final,
        num_seqs=num_seqs,
        num_conflicted=int(conflicted_mask.sum()),
    )
