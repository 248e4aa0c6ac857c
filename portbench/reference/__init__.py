"""Plain references, one module a configuration kind. They import
nothing of the program under test."""
