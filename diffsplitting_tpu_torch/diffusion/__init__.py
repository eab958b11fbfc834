from .ddpm import DDPMProcess
from .indi import InDIProcess
from .joint_indi import JointInDIProcess
from .schedules import DDPMSchedule, build_ddpm_schedule, make_beta_schedule
from .sr3 import SR3Process

__all__ = ["DDPMProcess", "DDPMSchedule", "InDIProcess", "JointInDIProcess", "SR3Process",
           "build_ddpm_schedule", "make_beta_schedule"]
