"""Property-path expression AST (the parser's; path evaluation is not part
of this package yet)."""
