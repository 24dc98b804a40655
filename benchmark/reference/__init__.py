"""Plain references, one module a generator, named after it. Each reads
only the generated rows and the request contexts: nothing of the program
and nothing it made."""
