"""Host utilities of a search: `checkpoint.SearchCheckpoint` (resume) and
`trace.PhaseTimer` (phase times, reads/s)."""
