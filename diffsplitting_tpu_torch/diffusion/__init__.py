from .indi import InDIProcess
from .joint_indi import JointInDIProcess

__all__ = ["InDIProcess", "JointInDIProcess"]
