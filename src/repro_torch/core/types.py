"""Shared constants of the QAC core.

Conventions (as in the JAX package):
  * term ids are 1-based; 0 is the PAD term.
  * docids are 0-based score ranks (0 = best score); INF_DOCID is the sentinel.
  * all variable-length data is padded to fixed shapes; correctness is masked.
"""
PAD_TERM = 0
INF_DOCID = 2**31 - 1          # int32 max: sorts after every real docid
CHARS_PER_CHUNK = 3            # 3 bytes per int32 chunk keeps keys non-negative
MAX_TERM_CHARS = 24            # padded term length
MAX_TERMS = 8                  # padded terms per completion
