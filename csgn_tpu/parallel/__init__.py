"""Multi-device SPMD layer: mesh construction + collective homomorphic ops.

The reference is single-threaded, single-process (SURVEY.md §2c); this package
is the from-scratch scaling story: ciphertext chunk axes and encryption
batch axes shard over a `jax.sharding.Mesh`, with XLA collectives
(all_gather / ppermute / psum) between the devices.
"""

from csgn_tpu.parallel.batch_ops import (
    batch_chunk_mesh,
    shard_batch,
    sharded_decrypt_batch,
    sharded_mul_batch,
    sharded_permute_batch,
)
from csgn_tpu.parallel.mesh import chunk_mesh, make_mesh
from csgn_tpu.parallel.multihost import (
    global_chunk_mesh,
    initialize,
    pad_chunks_to,
    shard_ciphertext,
)
from csgn_tpu.parallel.ops import (
    sharded_decrypt_parity,
    sharded_encrypt_bits,
    sharded_encrypt_bits_invariant,
    sharded_mul_allgather,
    sharded_mul_broadcast,
    sharded_mul_decrypt,
    sharded_mul_ring,
    sharded_permute,
)

__all__ = [
    "make_mesh",
    "chunk_mesh",
    "batch_chunk_mesh",
    "shard_batch",
    "sharded_mul_batch",
    "sharded_decrypt_batch",
    "sharded_permute_batch",
    "global_chunk_mesh",
    "initialize",
    "pad_chunks_to",
    "shard_ciphertext",
    "sharded_mul_allgather",
    "sharded_mul_broadcast",
    "sharded_mul_decrypt",
    "sharded_mul_ring",
    "sharded_encrypt_bits_invariant",
    "sharded_decrypt_parity",
    "sharded_encrypt_bits",
    "sharded_permute",
]
