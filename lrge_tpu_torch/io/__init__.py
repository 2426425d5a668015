from .records import count_records, iter_records, read_id_from_header
from .sniff import CompressionFormat, detect_compression_format, open_decompressed

__all__ = [
    "count_records",
    "iter_records",
    "read_id_from_header",
    "CompressionFormat",
    "detect_compression_format",
    "open_decompressed",
]
