"""XTree ("CrossTree") capability layer of the port — the reference's
second-generation tool (xtree.c): flat KPod-grid database, dual-hierarchy
taxonomy, confidence/LCA calling, capitalist redistribution, coverage
outputs.  Counterpart of `utree_tpu/xtree/`; ALIGN's k-mer front end runs on
the GPU through kernel K9 `csrc/xtree_probe.cu` (`xtree.device`)."""

from utree_tpu_torch.xtree.build import build_xtree_db, read_xtr, write_xtr, XtreeDB

__all__ = ["build_xtree_db", "read_xtr", "write_xtr", "XtreeDB"]
