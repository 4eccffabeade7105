"""`SearchPipeline(...)`: the device table that `lookup_mode` resolves to
(`pipeline.SearchPipeline._build_table`, `hash_index`), placed on the card,
with the vote tables and the native libraries (host clock)."""


def read(ctx):
    return ctx.setup["table_build_s"]
