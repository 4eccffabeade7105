"""Host input: linearized FASTA records (`fasta.iter_fasta_records`)."""
