"""Diagnostic harnesses (counterpart of the reference's ``tools/``)."""
