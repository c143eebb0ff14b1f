"""The LM serving engine's steps: prefill, decode and token sampling."""
