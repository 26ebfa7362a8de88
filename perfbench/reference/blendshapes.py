"""ARKit blendshape vocabulary and the mouth / expression index split.

28 mouth blendshapes (4 jaw, 23 mouth, tongueOut) are driven by the mel
stream; the other 24 by the emotion stream.
"""

from __future__ import annotations

import numpy as np

ARKIT_BLENDSHAPES: tuple[str, ...] = (
    "eyeBlinkLeft", "eyeLookDownLeft", "eyeLookInLeft", "eyeLookOutLeft",
    "eyeLookUpLeft", "eyeSquintLeft", "eyeWideLeft", "eyeBlinkRight",
    "eyeLookDownRight", "eyeLookInRight", "eyeLookOutRight", "eyeLookUpRight",
    "eyeSquintRight", "eyeWideRight", "jawForward", "jawLeft", "jawRight",
    "jawOpen", "mouthClose", "mouthFunnel", "mouthPucker", "mouthLeft",
    "mouthRight", "mouthSmileLeft", "mouthSmileRight", "mouthFrownLeft",
    "mouthFrownRight", "mouthDimpleLeft", "mouthDimpleRight",
    "mouthStretchLeft", "mouthStretchRight", "mouthRollLower",
    "mouthRollUpper", "mouthShrugLower", "mouthShrugUpper", "mouthPressLeft",
    "mouthPressRight", "mouthLowerDownLeft", "mouthLowerDownRight",
    "mouthUpperUpLeft", "mouthUpperUpRight", "browDownLeft", "browDownRight",
    "browInnerUp", "browOuterUpLeft", "browOuterUpRight", "cheekPuff",
    "cheekSquintLeft", "cheekSquintRight", "noseSneerLeft", "noseSneerRight",
    "tongueOut",
)
NUM_BLENDSHAPES: int = len(ARKIT_BLENDSHAPES)

MOUTH_BLENDSHAPES: tuple[str, ...] = (
    "jawForward", "jawLeft", "jawRight", "jawOpen",
    "mouthClose", "mouthFunnel", "mouthPucker", "mouthLeft", "mouthRight",
    "mouthSmileLeft", "mouthSmileRight", "mouthFrownLeft", "mouthFrownRight",
    "mouthDimpleLeft", "mouthDimpleRight", "mouthStretchLeft",
    "mouthStretchRight", "mouthRollLower", "mouthRollUpper",
    "mouthShrugLower", "mouthShrugUpper", "mouthPressLeft", "mouthPressRight",
    "mouthLowerDownLeft", "mouthLowerDownRight", "mouthUpperUpLeft",
    "mouthUpperUpRight",
    "tongueOut",
)

MOUTH_INDICES: tuple[int, ...] = tuple(
    i for i, name in enumerate(ARKIT_BLENDSHAPES)
    if name in frozenset(MOUTH_BLENDSHAPES))
EXPRESSION_INDICES: tuple[int, ...] = tuple(
    i for i in range(NUM_BLENDSHAPES) if i not in set(MOUTH_INDICES))
assert len(MOUTH_INDICES) == 28 and len(EXPRESSION_INDICES) == 24

