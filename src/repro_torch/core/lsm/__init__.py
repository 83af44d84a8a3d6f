from .arena import MemoryArena  # noqa: F401
from .baselines import AccordionMemComponent, BTreeMemComponent  # noqa: F401
from .cache import ClockCache, Disk, IOStats  # noqa: F401
from .grouped_l0 import FlatL0, GroupedL0  # noqa: F401
from .levels import DiskLevels  # noqa: F401
from .memtable import PartitionedMemComponent  # noqa: F401
from .sstable import SSTable, merge_runs, partition_run  # noqa: F401
from .storage import LSMStore, StoreConfig, TimeModel  # noqa: F401
from .tree import LSMTree  # noqa: F401
