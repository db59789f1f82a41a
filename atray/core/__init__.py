from atray.core.camera import Camera, make_camera, camera_rays
from atray.core import intersect
