"""Models of the port (NCHW inside; NHWC at the detector's entry). The
guided-anchoring heads, which no detector builds, are exported here."""

from vps_torch.models.ga_heads import (  # noqa: F401
    GARPNHead,
    GARetinaHead,
    GuidedAnchorHead,
)
