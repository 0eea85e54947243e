"""Matrix families: ``<family>.py`` defines ``triangle(**params)``, one
stored triangle of a symmetric matrix as 0-based NumPy triplets
``(rows, cols, vals, n)`` with rows >= cols, the form a Matrix Market
file of the reference's carries (its loader mirrors every off-diagonal
entry)."""
