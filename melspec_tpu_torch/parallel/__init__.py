"""Scale-out on ``torch.distributed``: one process per GPU, each rank's
callables on its own block of rows or streams (port of
``melspec_tpu.parallel``)."""

from melspec_tpu_torch.parallel.sharding import (
    make_mesh,
    shard_batch,
    sharded_frontend_step,
    sharded_multistream,
    sharded_serving,
    sharded_whisper_mel,
)
from melspec_tpu_torch.parallel.multihost import (
    chunk_audio,
    global_batch_from_local,
    load_host_shard,
    multihost_frontend,
    shard_files_for_host,
)

__all__ = [
    "make_mesh",
    "shard_batch",
    "sharded_frontend_step",
    "sharded_multistream",
    "sharded_serving",
    "sharded_whisper_mel",
    "chunk_audio",
    "global_batch_from_local",
    "load_host_shard",
    "multihost_frontend",
    "shard_files_for_host",
]
