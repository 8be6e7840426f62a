"""Special-token and index constants (the same values as
`oryx_tpu.constants`)."""

# Label value ignored by the cross-entropy loss (visual spans, prompt spans).
IGNORE_INDEX = -100

# Sentinel token id used host-side only to mark where visual embeddings are
# spliced into the text stream. Never reaches the embedding table: the
# splicer (models/splice.py) replaces it with an index map.
IMAGE_TOKEN_INDEX = -200

DEFAULT_IMAGE_TOKEN = "<image>"
DEFAULT_VIDEO_TOKEN = "<video>"
DEFAULT_IM_START_TOKEN = "<im_start>"
DEFAULT_IM_END_TOKEN = "<im_end>"

# Modality tags used by the Dynamic Compressor ratio selection
# (image -> 1x, multi-image/short video -> 4x, long video -> 16x).
MODALITY_IMAGE = "image"
MODALITY_MULTI_IMAGE = "multi_image"
MODALITY_VIDEO = "video"

# Area-compression ratio per modality (downsample factor per spatial side is
# sqrt of this).
COMPRESSOR_RATIO = {
    MODALITY_IMAGE: 1,
    MODALITY_MULTI_IMAGE: 4,
    MODALITY_VIDEO: 16,
}
