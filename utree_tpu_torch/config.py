"""Configuration of a UTree database and search (the port's copy of
`utree_tpu/config.py`).

The reference configures itree.c entirely through compile-time -D defines
(itree.c:18-26, 35-70; README.md:85-108).  Here the same knobs are fields of
one dataclass, validated at construction, used by build/compress/search alike.
"""

from __future__ import annotations

import dataclasses


# Word type sizes keyed by PACKSIZE, mirroring itree.c:55-70.
_WTYPE_BYTES = {4: 1, 8: 2, 16: 4, 32: 8, 64: 16}


@dataclasses.dataclass(frozen=True)
class UTreeConfig:
    """All build/search knobs of the reference, as one config object.

    Field -> reference mapping:
      packsize          PACKSIZE (k-mer length, itree.c:41-43)
      pfbits            PFBITS (build hash prefix bits, itree.c:45-53)
      ixtype_bytes      sizeof(IXTYPE) (itree.c:35-37): 2 or 4
      complevel         lv / "complevel" CLI arg (itree.c:1396-1397, 603-616)
      critical_cutoff   global critical_cutoff (itree.c:74)
      taxacut           TAXACUT (itree.c:1025-1027)
      slack             SLACK (itree.c:955-957)
      sparsity          SPARSITY (itree.c:958-960)
      tolerance         TOLERANCE_THRESHOLD (itree.c:952-954)
      ctr_trim_bytes    CMP=3: bytes trimmed from each word in the .ctr
                        (itree.c:690), giving the 24-bit search prefix.
    """

    packsize: int = 32
    pfbits: int = 24
    ixtype_bytes: int = 2
    complevel: int = 1
    critical_cutoff: int = 2
    taxacut: int = 4
    slack: int = 2
    sparsity: int = 4
    tolerance: int = 2
    ctr_trim_bytes: int = 3

    def __post_init__(self):
        if self.packsize not in _WTYPE_BYTES:
            raise ValueError(f"packsize must be one of {sorted(_WTYPE_BYTES)}")
        if self.ixtype_bytes not in (2, 4):
            raise ValueError("ixtype_bytes must be 2 or 4")
        if not 0 <= self.complevel <= 4:
            raise ValueError("complevel must be 0..4")
        if self.pfbits < 1 or self.pfbits >= 2 * self.packsize:
            raise ValueError("pfbits out of range")

    # --- derived quantities -------------------------------------------------

    @property
    def wtype_bytes(self) -> int:
        """sizeof(WTYPE) for this k (itree.c:55-70)."""
        return _WTYPE_BYTES[self.packsize]

    @property
    def word_bits(self) -> int:
        """2 bits per base (itree.c:618-621)."""
        return 2 * self.packsize

    @property
    def bad_ix(self) -> int:
        """BAD_IX = (IXTYPE)-1 (itree.c:105)."""
        return (1 << (8 * self.ixtype_bytes)) - 1

    @property
    def empty_ix(self) -> int:
        """EMPTY_IX = (IXTYPE)-2 (itree.c:106)."""
        return (1 << (8 * self.ixtype_bytes)) - 2

    # CTR ("compressed tree") search-index constants, itree.c:689-695.

    @property
    def ctr_prefix_bits(self) -> int:
        """PXBITS = CMP*8 = 24 by default (itree.c:690)."""
        return self.ctr_trim_bytes * 8

    @property
    def ctr_suffix_bits(self) -> int:
        """SXBITS = 2*PACKSIZE - PXBITS = 40 by default (itree.c:694)."""
        return self.word_bits - self.ctr_prefix_bits

    @property
    def ctr_num_bins(self) -> int:
        """NUMBINS = 2^PXBITS + 1 (itree.c:693)."""
        return (1 << self.ctr_prefix_bits) + 1

    @property
    def ctr_record_bytes(self) -> int:
        """SZ = sizeof(WTYPE) + sizeof(IXTYPE) - CMP (itree.c:691)."""
        return self.wtype_bytes + self.ixtype_bytes - self.ctr_trim_bytes

    @property
    def ctr_suffix_bytes(self) -> int:
        """CMPWDSZ = sizeof(WTYPE) - CMP (itree.c:692)."""
        return self.wtype_bytes - self.ctr_trim_bytes

    @property
    def suffix_mask(self) -> int:
        """Low-SXBITS mask over the word (MASK, itree.c:780-783)."""
        return (1 << self.ctr_suffix_bits) - 1

    def validate_for_v0(self) -> None:
        """The v0 device path implements the default 32-mer geometry."""
        if self.packsize not in (32, 64):
            raise NotImplementedError("device path supports packsize 32/64")


DEFAULT_CONFIG = UTreeConfig()
