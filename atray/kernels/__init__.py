from atray.kernels.bvh_hit import bvh_hit_pallas, first_hit, kernel_mode
