from .active_set import (NullSpace, NullSpaceMasked, active, active_masks,
                         extended_jacobian, extended_jacobian_knotrows,
                         extended_residual, get_collision_block, hcol,
                         lane_slice,
                         nullspace_basis, ordered_pairs, pair_active_flags,
                         sizes, unordered_pairs, update_nullspace,
                         update_nullspace_masked, vrow)

__all__ = [
    "NullSpace", "NullSpaceMasked", "active", "active_masks",
    "extended_jacobian", "extended_jacobian_knotrows", "extended_residual",
    "get_collision_block", "hcol", "lane_slice", "nullspace_basis",
    "ordered_pairs", "pair_active_flags", "sizes", "unordered_pairs",
    "update_nullspace", "update_nullspace_masked", "vrow",
]
