from .node import CfgNode
from .defaults import get_default_cfg

# Global config instance, mirroring the reference's `from wetectron.config
# import cfg` singleton usage. Library code takes cfg as an argument; the
# singleton exists for CLI-tool parity.
cfg = get_default_cfg()

__all__ = ["CfgNode", "get_default_cfg", "cfg"]
