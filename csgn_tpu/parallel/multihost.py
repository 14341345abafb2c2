"""Multi-host SPMD entry points.

One code path serves one chip, one host, and N hosts: the shard_map ops in
`parallel.ops` are written against a Mesh, and JAX compiles the same program
per host under `jax.distributed`.  This module wraps the initialization
handshake and global mesh construction; the 8-device virtual CPU mesh used in
tests exercises the identical compiled collectives.

Elastic recovery model (SURVEY.md §5): the checkpoint is the recovery unit.
`csgn_tpu.io` snapshots are host arrays with no sharding baked in, so a
resumed job may come back with a different device count — `shard_state`
re-lays the chunk axis onto whatever mesh exists at resume time (tested in
tests/test_elastic.py by resharding across mesh sizes).
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from csgn_tpu.ciphertext import Ciphertext
from csgn_tpu.parallel.mesh import CHUNK_AXIS, make_mesh

__all__ = ["initialize", "global_chunk_mesh", "shard_ciphertext", "pad_chunks_to"]


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None,
               local_device_ids: "list[int] | None" = None) -> None:
    """`jax.distributed.initialize` passthrough (env-driven when args omitted).

    Call once per process before any jax computation in multi-process runs.
    ``local_device_ids`` restricts this process to those local devices — a
    launch with one process per card passes its own card's id, so that no
    process claims every card of the host.
    """
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )


def global_chunk_mesh() -> Mesh:
    """1-D mesh over every device in the job (all hosts)."""
    return make_mesh((len(jax.devices()),), (CHUNK_AXIS,))


def pad_chunks_to(ct: Ciphertext, multiple: int) -> tuple[Ciphertext, int]:
    """Zero-pad the chunk axis to a multiple (zero chunks are decrypt-neutral:
    they never match a nonzero mask).  Returns (padded, original_chunks)."""
    import jax.numpy as jnp

    ct = ct.canonical()  # sharding pads are untracked: resolve any order tag
    c = ct.chunks
    cp = -(-c // multiple) * multiple
    if cp == c:
        return ct, c
    wt = jnp.pad(ct.wt, ((0, 0), (0, cp - c)))
    return Ciphertext(wt, ct.ctx), c


def shard_ciphertext(ct: Ciphertext, mesh: Mesh, axis: str = CHUNK_AXIS) -> Ciphertext:
    """Place a ciphertext with its chunk axis sharded over the mesh.

    Pads the chunk axis to the mesh size first; use after loading a
    checkpoint to re-lay data onto the current (possibly different-sized)
    mesh.
    """
    nd = mesh.shape[axis]
    padded, _ = pad_chunks_to(ct, nd)
    sharding = NamedSharding(mesh, P(None, axis))
    return Ciphertext(jax.device_put(padded.wt, sharding), ct.ctx)
