from repro_torch.storage.tier import (  # noqa: F401
    DRAMTier, DeviceSpec, PAPER_DRAM, PAPER_SSD, SSDTier, Tier,
)
from repro_torch.storage.topology import StorageTopology  # noqa: F401
