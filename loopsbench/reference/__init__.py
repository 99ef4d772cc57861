"""The plain references the checks compare with: plain PyTorch that
imports nothing of the program."""
