"""MIND-style TSV column layout.

Mirrors the behavioral contract of the reference data format
(reference: src/constants.py:1-10): `behaviors.tsv` rows are
(impression id, user id, time, history, behaviors) and `news.tsv` rows are
(news id, title, category, sapo/abstract).
"""

# behaviors.tsv columns
IMPRESSION_ID = 0
USER_ID = 1
TIME = 2
HISTORY = 3
BEHAVIOR = 4

# news.tsv columns
NEWS_ID = 0
TITLE = 1
CATEGORY = 2
SAPO = 3

# Special vocab entries expected in category2id / user2id maps.
PAD_TOKEN = "pad"
UNK_TOKEN = "unk"
