"""aruco3_tpu_torch — the PyTorch/CUDA port of aruco3_tpu.

ArUco/AprilTag fiducial detection and IPPE pose estimation on PyTorch
tensors: the same pipeline, dictionaries and pose solve as the JAX
package, with its four TPU kernels rewritten as CUDA C++ kernels for
Hopper (``ops``).  On CUDA tensors the detector launches the kernels; on
CPU tensors it runs their plain PyTorch versions.  Imports no JAX.
"""

from .camera import CameraExtrinsics, CameraIntrinsics, CameraModel
from .detector import Detection, Detector, DetectorConfig, Marker
from .dictionaries import ARDictionary, get_dictionary_names
from .pose import MarkerPose
from .utils.bits import hamming_distance
from . import pose

__all__ = [
    "ARDictionary",
    "CameraExtrinsics",
    "CameraIntrinsics",
    "CameraModel",
    "Detection",
    "Detector",
    "DetectorConfig",
    "Marker",
    "MarkerPose",
    "get_dictionary_names",
    "hamming_distance",
    "pose",
]

__version__ = "0.1.0"
