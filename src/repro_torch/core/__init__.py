"""The RCB runtime: RCTC, RCB, RIMFS, RHAL, RBL, linker, executor, RTPM."""
