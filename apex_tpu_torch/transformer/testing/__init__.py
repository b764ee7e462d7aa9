"""Test harness of the port (``apex/transformer/testing`` parity)."""
