"""One module per driver kind; a traffic file names its driver."""
