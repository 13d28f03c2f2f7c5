"""FIGARO RELOC: segment relocation from a slow pool into a fast pool."""
