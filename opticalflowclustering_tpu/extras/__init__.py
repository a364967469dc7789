"""Library ports of the reference's auxiliary workloads (SURVEY.md §2.2).

Each module is the batched JAX equivalent of one reference demo
directory, exposed as pure functions (no imshow/waitKey — the reference's
interactive display is replaced by returned arrays the caller can save).
"""
