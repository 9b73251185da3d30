"""Several processes, one card or CPU each: chains, members, draws and the
rows of K split over the ranks of a ``torch.distributed`` device mesh.

Mirrors gpr_tpu/parallel/__init__.py.  ``dryrun_multichip`` mirrors
``__graft_entry__.dryrun_multichip`` (__graft_entry__.py:55-230).
"""

from . import dryrun, sharded_gram, sharded_hmc  # noqa: F401
from .dryrun import dryrun_multichip  # noqa: F401
from .sharded_gram import (  # noqa: F401
    cho_solve_sharded,
    cholesky_sharded,
    default_mesh,
    fit_sharded,
    sharded_gram as gram_sharded,
)
from .sharded_hmc import (  # noqa: F401
    initialize_distributed,
    sample_hmc_sharded,
    sample_hmc_sharded_chunked,
    sample_nuts_sharded_chunked,
)
