"""Host data pipeline of the port (copies of ``case_rg_tpu/data``'s
JAX-free modules that serving needs: text, vocab, labels, featurize)."""

from .featurize import featurize, sample_metadata
from .text import (WordPieceTokenizer, basic_tokenize, bert_detokenize,
                   split_sentences)
from .vocab import (Vocabulary, freq_table_from_counts, load_freq_table,
                    load_freq_table_json, save_freq_table)
