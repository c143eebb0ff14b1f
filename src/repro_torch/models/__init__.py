"""Model parameter layouts, initialization and the LM forward passes."""
