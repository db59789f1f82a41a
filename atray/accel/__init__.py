from atray.accel.bvh import BVH, build_bvh, refit_bvh, validate_bvh
from atray.accel.traverse import bvh_first_hit
