"""The plain reference against a database and reads worked out by hand."""

import numpy as np
import pytest

from portbench.reference.classify import Reference, bin_offsets
from portbench.reference.vote import aufbau_vote_counts

CODE = {"A": 0, "C": 1, "G": 2, "T": 3}
COMP = str.maketrans("ACGT", "TGCA")


def word(kmer: str) -> int:
    w = 0
    for ch in kmer:
        w = (w << 2) | CODE[ch]
    return w


def rc(s: str) -> str:
    return s.translate(COMP)[::-1]


K1 = "ACGTACGTACGTACGTACGTACGTACGTACGA"
K2 = "TTGCATTGCATTGCATTGCATTGCATTGCAAA"
K3 = "GGGGCCCCAAAATTTTGGGGCCCCAAAATTTC"
STRINGS = [b"k__a;p__b", b"k__a;p__b;c__c", b"k__x"]


def reference(drop_bases=0):
    # two records in the lowest bin keep the compressor's first-bin quirk
    # out of the way of K1-K3 (test_bin_offsets_quirks has it)
    words = [word("A" * 32), word("A" * 31 + "C"), word(K1), word(K2), word(K3)]
    order = np.argsort(np.array(words, np.uint64))
    w = np.array(words, np.uint64)[order]
    ixs = np.array([2, 2, 0, 1, 2], np.int64)[order]
    return Reference(w, ixs, STRINGS, 4, "cpu", drop_bases)


def as_reads(seqs):
    n = max(len(s) for s in seqs)
    if any(len(s) != n for s in seqs):
        raise ValueError("one length a test")
    return np.frombuffer("".join(seqs).encode(), np.uint8).reshape(len(seqs), n).copy()


NAMES = lambda i: b"r%d" % i


def test_bin_offsets_quirks():
    # a single record in the lowest populated bin: its bin stays 0, the next
    # populated bin's start (1) is the first nonzero entry and is zeroed, and
    # the empty bins after it take the next start
    b = bin_offsets(np.array([5, 7, 7, 9], np.int64))
    assert b[:5].tolist() == [0] * 5
    assert b[5:11].tolist() == [0, 0, 0, 3, 3, 4]
    assert b[-1] == 4 and len(b) == (1 << 24) + 1
    # two records in the lowest bin: it gets 1, then the zeroing repairs it
    b = bin_offsets(np.array([5, 5, 9], np.int64))
    assert b[5:11].tolist() == [0, 2, 2, 2, 2, 3]


def test_hand_worked_lines():
    reads = as_reads([
        K1 + "G" * 32,                         # K1 once: label 0
        K2 + K2,                               # K2 twice (and no other window)
        K1[:16] + "N" * 16 + K2,               # only K2's window is valid
        rc(K3) + "C" * 32,                     # K3 on the RC strand only
        K1 + K2,                               # labels 0 and 1: the walk
        "C" * 64,                              # no hit: no line
    ])
    want_rc = [b"r0\tk__a;p__b\t1\t1\t*", b"r1\tk__a;p__b;c__c\t2\t1\t*",
               b"r2\tk__a;p__b;c__c\t1\t1\t*", b"r3\tk__x\t1\t1\t*",
               b"r4\tk__a;p__b;c__c\t2\t2\t1;1"]
    assert reference().lines(reads, NAMES, do_rc=True) == want_rc
    assert reference().lines(reads, NAMES, do_rc=False) == [
        x for x in want_rc if not x.startswith(b"r3")]


def test_support8_adds_seven_pairs():
    reads = as_reads([K1 + K2])
    (line,) = reference().lines(reads, NAMES, do_rc=True, support_ranges=8)
    # the walk's rank 0 reads (2, 2); rank 1 (2, 2), then (1, 1) once the
    # prefix label is promoted away; ranks 2-7 are never reached
    assert line == b"r0\tk__a;p__b;c__c\t2\t2\t1;1\t1;1" + b"\t0;0" * 6


# worked by hand from SURVEY.md section 2.5 (itree.c:1028-1098): cutoff =
# n - n/4, bumped when n/2 >= it; labels sorted by string, grouped rank by
# rank while the leading group's count reaches the cutoff
@pytest.mark.parametrize("counts,want", [
    # 4 hits: 3 of p__b pass the phylum's cutoff 3 (4 - 1) as the last
    # candidate, so the whole string; support 3 of range 4
    ((3, 1), b"q\tk__a;p__b\t4\t2\t3;4"),
    # 2 and 2: the kingdom holds all 4, the phylum's 2 miss the cutoff 3, so
    # the kingdom; support 2 of range 4
    ((2, 2), b"q\tk__a\t4\t2\t2;4"),
])
def test_hand_worked_vote(counts, want):
    strings = [b"k__a;p__c", b"k__a;p__b"]  # sorted apart from their ids
    got = aufbau_vote_counts(b"q", np.array([1, 0]), np.array(counts), strings, 4)
    assert got == want


@pytest.mark.parametrize("drop", [1, 2])
def test_control_matches_a_changed_last_base(drop):
    # K1 with its last base changed: a miss at full precision, a hit when
    # the last bases are not compared
    near = K1[:-1] + "T"
    reads = as_reads([near + "C" * 8])
    assert reference().lines(reads, NAMES, do_rc=False) == []
    assert reference(drop).lines(reads, NAMES, do_rc=False) == [b"r0\tk__a;p__b\t1\t1\t*"]
