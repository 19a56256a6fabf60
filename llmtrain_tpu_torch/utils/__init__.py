"""Small shared utilities (structured logging)."""
