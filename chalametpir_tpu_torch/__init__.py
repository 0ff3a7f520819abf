"""chalametpir_tpu_torch — the ChalametPIR keyword PIR system on PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper.

Same protocol and wire formats as chalametpir_tpu, the JAX package it is
held against, with an explicit device. A package of its own: it keeps its
own copy of the framework-free layer it needs (params, errors, core/,
the native host engine, framing) and imports nothing of chalametpir_tpu:

    from chalametpir_tpu_torch import Server, Client
    server, hint, filter_params = Server.setup(seed, db, arity=3, device="cuda")
    client = Client.setup(seed, hint, filter_params, device="cuda")
    query = client.query(b"key")
    response = server.respond(query)
    value = client.process_response(b"key", response)

device="cpu" runs the plain torch versions of the kernels (the test path).
Subpackages: core/, native/, ops/, models/, net/, utils/, diag/, and
parallel/ (sharding over a mesh of devices or of torch.distributed ranks:
`Server.setup(..., mesh=parallel.make_mesh(...))`).
Importing this package imports neither jax nor chalametpir_tpu. The
native host engine is built with g++ on first use.
"""

from .core.filter import BinaryFuseFilter
from .errors import ArithmeticOverflowAddingQueryIndicator, ChalametPIRError
from .models.client import Client, Query
from .models.server import Server
from .params import LWE_DIMENSION, SEED_BYTE_LEN

__all__ = [
    "Server",
    "Client",
    "Query",
    "BinaryFuseFilter",
    "ChalametPIRError",
    "ArithmeticOverflowAddingQueryIndicator",
    "SEED_BYTE_LEN",
    "LWE_DIMENSION",
]

# the JAX package's version, whose behaviour this package reproduces
__version__ = "0.2.0"
