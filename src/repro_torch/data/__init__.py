from .lm import TokenStream, lm_batches  # noqa: F401
from .recsys_data import recsys_batch  # noqa: F401
