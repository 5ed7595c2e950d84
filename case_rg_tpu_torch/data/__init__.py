"""Host data pipeline of the port (copies of ``case_rg_tpu/data``'s
JAX-free modules: text, vocab, labels, featurize, loaders, batching,
prepare). Numpy only: nothing here imports torch."""

from .batching import Batcher, select_gold
from .featurize import featurize, sample_metadata
from .loaders import (assemble_samples, load_answer, load_passage, load_pool,
                      load_qrel, load_query, load_split, merge_eval,
                      split_samples)
from .prepare import load_prepared, prepare_dataset
from .text import (WordPieceTokenizer, basic_tokenize, bert_detokenize,
                   split_sentences)
from .vocab import (Vocabulary, freq_table_from_counts, load_freq_table,
                    load_freq_table_json, save_freq_table)
