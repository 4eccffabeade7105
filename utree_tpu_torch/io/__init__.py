"""Host input: linearized FASTA records (`fasta.iter_fasta_records`) and
the taxonomy map of a build (`maps.read_tax_map`)."""
