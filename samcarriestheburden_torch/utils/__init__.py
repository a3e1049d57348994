"""Reference-layout compatibility shims (JAX ``utils/``).

The reference keeps its algorithmic helpers under ``utils/`` (cvat_parser,
dice_coefficient, random_walk, seg_refinement, segmentation_preprocessing).
This package re-exports the port's implementations under the same module
names, so reference user code ports by changing only the root import.
"""
