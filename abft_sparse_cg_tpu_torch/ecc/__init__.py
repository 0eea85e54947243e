"""Software ECC: codeword layouts, the codec, value derivation, the fold.

``layout`` is a copy of the JAX package's; ``codec``, ``values`` and
``fold`` hold the tensor paths the device code uses plus the NumPy paths
the host build and fault injection use.
"""
