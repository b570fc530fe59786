from typing import Dict

from repro_torch.core.compression.base import (  # noqa: F401
    CompressedEntry, CompressionMethod, KVData, NoCompression, kv_nbytes,
    kv_num_tokens,
)
from repro_torch.core.compression.kivi import KIVICompression  # noqa: F401
from repro_torch.core.compression.mixed import DropQuantCompression  # noqa: F401
from repro_torch.core.compression.streaming_llm import StreamingLLMCompression  # noqa: F401


def default_registry(device="cuda") -> Dict[str, CompressionMethod]:
    """``device``: where the KIVI arms quantize and dequantize."""
    return {
        "none": NoCompression(),
        "kivi": KIVICompression(device=device),
        "streaming_llm": StreamingLLMCompression(),
        "drop_kivi": DropQuantCompression(device=device),
    }
