"""Configuration: the port's own copies of ``case_rg_tpu.config.
DataConfig``, ``ModelConfig``, ``MODEL_NAMES`` and of the single-device part
of ``TrainConfig`` (same fields and defaults, so a JAX config's values carry
over one for one)."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class DataConfig:
    """Offline featurization constants (ref: Prepare_dataset.py:13-20)."""

    dataset: str = "cast"
    data_path: str = "./dataset/"
    query_len: int = 60
    passage_len: int = 100
    num_passage: int = 10
    max_span_size: int = 4
    answer_len: int = 40          # max_target_length in the reference
    min_window_size: int = 4      # GLKS
    num_windows: int = 1          # GLKS
    pool_topk: int = 10
    pool_candidates: int = 100    # load_pool(topk=10*topk) (Prepare_dataset.py:153)
    vocab_file: Optional[str] = None   # BERT-style vocab.txt; None => corpus vocab
    vocab_min_freq: int = 1
    seed: int = 123456


@dataclass(frozen=True)
class ModelConfig:
    """Architecture knobs shared by the six models."""

    name: str = "case"
    vocab_size: int = 0           # filled in from the vocabulary at build time
    # special-token ids (corpus-vocab defaults; overridden from the vocab)
    pad_id: int = 0
    bos_id: int = 1
    unk_id: int = 2
    eos_id: int = 3
    embedding_size: int = 256
    hidden_size: int = 256
    num_heads: int = 8
    enc_layers: int = 3           # TransformerSeqEncoder depth (CaSE/Model.py:261)
    dec_layers: int = 4           # per-memory decoder depth (CaSE/Model.py:265)
    num_memories: int = 2
    tmemnet_layers: int = 8       # TMemNet enc/dec depth (TMemNet/Model.py:52,110)
    dropout: float = 0.1
    gru_dropout: float = 0.5      # baselines' embedding dropout (S2SA/Model.py:62)
    max_target_length: int = 40
    max_dec_len: int = 40
    beam_width: int = 1
    max_span_size: int = 4
    min_window_size: int = 4      # GLKS
    num_windows: int = 1          # GLKS
    label_smoothing: float = 0.0
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "float32"   # "bfloat16" for serving on the card

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class TrainConfig:
    """The training loop's knobs: the port's copy of the fields of
    ``case_rg_tpu.config.TrainConfig``, with the same defaults. Left out:
    the axis names and ``shard_vocab_dim`` (the 'model' axis, ROADMAP Queue
    1 item 7b) and ``ckpt_backend`` (the port writes its own checkpoint
    format only). ``mesh_shape`` is the data axis only: () or (D,) or
    (D, 1), D the ranks torchrun started (``runtime/mesh``);
    ``pool_shard=True`` is refused by the trainer (item 7b)."""

    batch_size: int = 16
    epochs: int = 20
    learning_rate: float = 2.5e-4
    warmup_steps: int = 2000
    num_cycles: int = 1            # cosine-with-hard-restarts cycles
    accumulation_steps: int = 1
    grad_clip: float = 1.0
    ema_decay: float = 0.995
    compute_dtype: str = "float32"   # "bfloat16": f32 masters, bf16 fwd/bwd
    remat: str = ""                  # recompute the forward in the backward:
                                     # "" (keep every residual), "dots" (keep
                                     # matmul outputs), "dots_batch" (and
                                     # batched ones), "nothing" (recompute
                                     # all); train/trainer.REMAT_POLICIES
    seed: int = 123456
    log_every: int = 100
    checkpoint_every_steps: int = 0   # 0 = epoch-end only
    output_path: str = "./output/"
    resume: bool = True
    # parallelism
    mesh_shape: Tuple[int, ...] = ()   # () => every rank on the data axis
    pool_shard: bool = False           # the pool axis over 'model': refused


# The reference's per-dataset constructor defaults differ, but
# Prepare_dataset.py:241-311 passes the same global constants
# (query_len=60, passage_len=100, num_passage=10, max_target_length=40)
# to every model's dataset, so featurization shapes are shared.
MODEL_NAMES = ("case", "masque", "glks", "tmemnet", "gttp", "s2sa")
