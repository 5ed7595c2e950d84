"""Answer and ranking metrics (a copy of ``case_rg_tpu/evaluation``)."""

from .bleu import eval_bleu, sentence_bleu
from .harness import eval_all, eval_answer_file
from .meteor import eval_meteor, meteor_score, single_meteor_score
from .overlap import eval_overlap
from .rouge import eval_rouge, rouge_scores
from .trec import eval_trec, eval_trec_file, parse_qrel, parse_run
