"""Special-token vocabulary constants (a copy of
``case_rg_tpu/constants.py``).

TPU-native rebuild of the reference's tag/constant tables
(ref: common/Constants.py:1-33). The reference names BOS/EOS after BERT's
unused wordpiece slots ('[unused0]'/'[unused1]'); we keep the same surface
words so vocab files produced for the reference load unchanged.
"""

PAD_WORD = "[PAD]"
BOS_WORD = "[unused0]"
UNK_WORD = "[UNK]"
EOS_WORD = "[unused1]"
SEP_WORD = "[SEP]"
CLS_WORD = "[CLS]"
MASK_WORD = "[MASK]"

SPECIAL_WORDS = (PAD_WORD, BOS_WORD, UNK_WORD, EOS_WORD, SEP_WORD, CLS_WORD, MASK_WORD)

# Canonical ids used when the framework builds its own vocabulary
# (mirrors the layout of common/Utils.py:413-415 build-side vocabs).
PAD_ID = 0
BOS_ID = 1
UNK_ID = 2
EOS_ID = 3
SEP_ID = 4
CLS_ID = 5
MASK_ID = 6

# POS / NER tag inventories (ref: common/Constants.py:9-33). Unused by the six
# models but part of the reference's public constant surface.
UNIVERSAL_POS = [
    "ADJ", "ADP", "ADV", "AUX", "CONJ", "CCONJ", "DET", "INTJ", "NOUN",
    "NUM", "PART", "PRON", "PROPN", "PUNCT", "SCONJ", "SYM", "VERB", "X",
    "SPACE",
]
NER_TAGS = [
    "O", "PERSON", "NORP", "FAC", "ORG", "GPE", "LOC", "PRODUCT", "EVENT",
    "WORK_OF_ART", "LAW", "LANGUAGE", "DATE", "TIME", "PERCENT", "MONEY",
    "QUANTITY", "ORDINAL", "CARDINAL",
]


def _tag_maps(tags):
    tag2id = {PAD_WORD: 0, CLS_WORD: 1, EOS_WORD: 2}
    id2tag = {0: PAD_WORD, 1: CLS_WORD, 2: EOS_WORD}
    for t in tags:
        tag2id[t] = len(tag2id)
        id2tag[len(id2tag)] = t
    return tag2id, id2tag


pos2id, id2pos = _tag_maps(UNIVERSAL_POS)
ner2id, id2ner = _tag_maps(NER_TAGS)
