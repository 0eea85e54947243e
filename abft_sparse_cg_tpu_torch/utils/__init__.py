"""Matrix generators shared by the tests and chip_smoke.py."""
