from .recsys_data import recsys_batch  # noqa: F401
