"""Row expressions: IR, host helpers and the device compiler."""
