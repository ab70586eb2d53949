"""The insecure mock backend of the port (test use only)."""
