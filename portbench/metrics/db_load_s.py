"""The DB's arrays made into the program's index,
`utree_tpu_torch.index.DeviceIndexArrays.from_build` (host clock)."""


def read(ctx):
    return ctx.setup["db_load_s"]
