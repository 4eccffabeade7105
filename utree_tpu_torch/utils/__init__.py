"""Host utilities of a search: `checkpoint.SearchCheckpoint` (resume) and
`trace` (phase times and counters, the process's own record, the
torch.profiler trace)."""
