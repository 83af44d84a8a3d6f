# Only the ghost cache so far: the memory tuner itself is not ported yet.
from .simcache import GhostCache  # noqa: F401
