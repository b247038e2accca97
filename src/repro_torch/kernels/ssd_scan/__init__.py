from .ops import ssd
from .ref import reference_ssd, ssd_chunked

__all__ = ["ssd", "reference_ssd", "ssd_chunked"]
