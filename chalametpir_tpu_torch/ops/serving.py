"""What `models.server.Server` serves from: `respond_packed.PackedPlanes`,
`respond.DigitPlanes`, `parallel.ShardedPlanes` or `respond.HostPlanes`
(the numpy oracle's D). Each has `upload` (host uint32 queries to what
`respond` takes), `respond` ((Q, m) to (Q, C) on its device), `readback`
(to host uint32), `fold_rows`, `device`, `num_cols`, `c_pad` (the hint
buffer's width), `archive()` (its arrays in `Server.save`) and
`archive_backend`; `from_archive` rebuilds a device state for `Server.load`."""

from __future__ import annotations

import numpy as np
import torch


class ServingState:
    """Defaults: torch tensors, u32 values as int32 of the same bits; a fold by `respond`."""

    # the backend under which the JAX package's load rebuilds the archive
    archive_backend = "jax"

    def upload(self, queries: np.ndarray) -> torch.Tensor:
        """To the state's own device, never the calling thread's current one
        (the TCP dispatcher responds from a worker thread)."""
        return torch.from_numpy(queries.view(np.int32)).to(self.device)

    def readback(self, out: torch.Tensor) -> np.ndarray:
        return out.cpu().numpy().view(np.uint32)

    def fold_rows(self, a_block, out_rows) -> None:
        """out_rows[:, :C] += A_block . D, the (r, m) rows of A as `respond` takes them."""
        out_rows[:, : self.num_cols] += self.respond(a_block)
