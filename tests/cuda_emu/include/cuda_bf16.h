// Resolved to the CPU emulation when csrc/*.cu is compiled by g++ (emu.h).
#pragma once
#include "emu.h"
