"""Structure-from-Motion front end: SIFT/SURF features, descriptor
matching, 8-point RANSAC (reference: libs/sfm/; port of mve_tpu.sfm)."""
