"""Plain references of what the cells compute; they import nothing of
the port."""
