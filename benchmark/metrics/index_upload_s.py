"""Seconds of the index upload in set-up (``Mapper.device_index``: the
packing, ``device_map.device_index_from_host`` and, on several cards,
``shard.replicate_index``), to the cards' synchronise."""


def read(ctx):
    return ctx.setup.get("index_upload_s")
