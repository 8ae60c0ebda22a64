from .types import INF_DOCID, MAX_TERMS, MAX_TERM_CHARS, CHARS_PER_CHUNK
from .builder import (CorpusStats, QACIndex, build_corpus, build_qac_index,
                      corpus_stats, parse_queries, tokenize)

__all__ = ["INF_DOCID", "MAX_TERMS", "MAX_TERM_CHARS", "CHARS_PER_CHUNK",
           "CorpusStats", "QACIndex", "build_corpus", "build_qac_index",
           "corpus_stats", "parse_queries", "tokenize"]
