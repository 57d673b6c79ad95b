from slimt_tpu_torch.io.marian import Item, load_items, save_items  # noqa: F401
from slimt_tpu_torch.io.loader import load_weights  # noqa: F401
