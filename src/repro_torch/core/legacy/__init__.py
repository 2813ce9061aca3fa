"""The legacy tuple-at-a-time row engine: row operators over host rows and
the row-based property paths."""
