"""qac-ebay: the paper's system at production scale."""
from .qac_common import QACArch

ARCH = QACArch(arch_id="qac-ebay")
