"""The PRL front end: parser, eager interpreter and builtins."""
