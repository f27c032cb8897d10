"""paddle.io.dataloader.collate of the port (reference:
python/paddle/io/dataloader/collate.py)."""
from .. import default_collate_fn  # noqa: F401


def default_convert_fn(batch):
    """reference: dataloader/collate.py default_convert_fn — identity
    conversion for already-tensor samples."""
    return batch
