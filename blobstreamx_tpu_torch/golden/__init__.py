"""Spec-derived pure-Python golden models (SURVEY.md §4.3 item 1).

These are the bit-exactness oracles for every device kernel. They share no
code with the device implementations (PyTorch or CUDA) and use only Python integers and
``hashlib``-independent primitives, so agreement between the two stacks is a
meaningful correctness signal.
"""
