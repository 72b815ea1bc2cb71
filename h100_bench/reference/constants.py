"""A frozen copy of the port's ``data/constants.py``.

Special-token sentinels and prompt tokens.

The port's own copy of ``psalm_tpu/data/constants.py`` (held equal by
``tests/test_torch_copies.py``). IDs mirror the reference
(psalm/constants.py:7-19) so tokenized streams are byte-compatible with the
released checkpoint's training data.
"""

IGNORE_INDEX = -100
IMAGE_TOKEN_INDEX = -200
SEG_TOKEN_INDEX = -201
CLS_TOKEN_INDEX = -202
REGION_TOKEN_INDEX = -203
REFER_TOKEN_INDEX = -204

DEFAULT_IMAGE_TOKEN = "<image>"
DEFAULT_SEG_TOKEN = "<seg>"
DEFAULT_CLS_TOKEN = "<cls>"
DEFAULT_REGION_TOKEN = "<region>"
DEFAULT_REFER_TOKEN = "<refer>"
DEFAULT_IMAGE_PATCH_TOKEN = "<im_patch>"
DEFAULT_IM_START_TOKEN = "<im_start>"
DEFAULT_IM_END_TOKEN = "<im_end>"

# Literal token appended to the tokenizer and used as the class-name suffix
# (train.py:450-452, train_datasets.py:224).
SEG_LITERAL_TOKEN = "[SEG]"

# Static-splice source types (psalm_tpu-specific; see data/splicer.py).
SRC_TEXT = 0
SRC_IMAGE = 1
SRC_SEG_QUERY = 2
SRC_REGION = 3
SRC_PAD = 4

# Serving constants (psalm/constants.py:1-2).
CONTROLLER_HEART_BEAT_EXPIRATION = 30
WORKER_HEART_BEAT_INTERVAL = 15
LOGDIR = "."
