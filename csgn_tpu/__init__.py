"""csgn_tpu — a CSGN/CertSGN bounded homomorphic encryption framework in JAX.

A from-scratch JAX/XLA re-design with the capabilities of the reference
certfhe/CSGN C++ library: one-bit ciphertexts as packed chunk tensors,
homomorphic add (chunk concat), homomorphic multiply (chunk cross-product AND),
secret-key encrypt/decrypt (per-chunk AND over d secret positions, parity over
chunks), and permutation key transforms — batched and shardable across
device meshes.

Public surface parity with the reference umbrella header (src/certFHE.h):
Context, Plaintext, SecretKey, Ciphertext, Permutation.  `Library`/`Helper`/
`Timer` have no equivalent by design: randomness is explicit counter-based
keys (`jax.random`), and timing lives in `csgn_tpu.utils.timing`.
"""

from csgn_tpu.batch import CiphertextBatch
from csgn_tpu.ciphertext import Ciphertext, set_eager_order
from csgn_tpu.circuit import CtExpr, lift
from csgn_tpu.config import RunConfig
from csgn_tpu.context import Context
from csgn_tpu.permutation import Permutation
from csgn_tpu.plaintext import Plaintext
from csgn_tpu.secret_key import SecretKey
from csgn_tpu.serve import BatchExecutor, ServeFuture

# Subpackages (io, ops, parallel, models, pipeline, utils) import lazily via
# their qualified names; the classes above are the reference-parity surface.

__version__ = "0.1.0"

__all__ = [
    "Context",
    "Plaintext",
    "SecretKey",
    "Ciphertext",
    "CiphertextBatch",
    "set_eager_order",
    "Permutation",
    "CtExpr",
    "lift",
    "RunConfig",
    "BatchExecutor",
    "ServeFuture",
    "__version__",
]
