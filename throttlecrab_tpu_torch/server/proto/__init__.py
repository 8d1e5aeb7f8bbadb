"""The reference's gRPC proto and its generated message classes."""
