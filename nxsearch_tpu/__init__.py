"""nxsearch-tpu: a GPU-resident full-text search engine in JAX.

A ground-up JAX/XLA/Pallas re-design of the capabilities of
rmind/nxsearch (BM25/TF-IDF ranking, boolean query logic, stemming,
fuzzy matching, filter plugins, REST service), built for one or more
NVIDIA GPUs: the inverted index is columnar CSR in device memory,
scoring is gathered + segment-summed on device, and boolean algebra
runs over packed bitmaps.
"""

from .errors import ErrorCode, NxsError
from .ingest import parallel_ingest
from .nxs import Index, Nxs
from .params import Params
from .resp import Response

__all__ = ["Nxs", "Index", "Params", "Response", "NxsError", "ErrorCode",
           "parallel_ingest"]
__version__ = "0.1.0"
