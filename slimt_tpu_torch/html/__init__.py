from slimt_tpu_torch.html.html import HTML  # noqa: F401
from slimt_tpu_torch.html.scanner import BadHTML, ScanError  # noqa: F401
