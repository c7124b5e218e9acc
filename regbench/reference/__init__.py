"""The plain references the comparison that decides `correct` runs."""
