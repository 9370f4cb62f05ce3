// nvdisc -- native NVIDIA card discovery shim.
//
// The port's twin of native/tpudisc.cc: a C ABI over raw devfs, sysfs
// and procfs reads, loaded with ctypes as the first rung of
// tpushare_torch/deviceplugin/discovery.py.
//
// A card is a device node <devfs>/nvidia<N> (or <devfs>/nvidia/nvidia<N>,
// where an image puts the nodes in a subdirectory); N is its minor
// number, the host index. The control nodes (nvidiactl, nvidia-uvm,
// nvidia-uvm-tools, nvidia-modeset, nvidia-caps/) and names such as
// nvidia0foo are not cards. Where the kernel module's procfs shows
// <procfs>/driver/nvidia/gpus/<bus id>/information, its "Device Minor"
// line ties a card to its PCI function, whose vendor, device and NUMA
// node are read from <sysfs>/bus/pci/devices/<bus id>/. Where neither
// shows the card, it is counted and left unnamed: the Python layer names
// it as it names the other rungs' cards.
//
// All three roots are parameters so tests can point the shim at a
// synthetic tree; production passes "/dev", "/sys" and "/proc".
//
// Built at first use with g++ (no dependencies) by discovery.py:
//   g++ -O2 -Wall -Wextra -fPIC -std=c++17 -shared -o libnvdisc.so nvdisc.cc

#include <cctype>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <dirent.h>
#include <initializer_list>
#include <string>

extern "C" {

// Keep in sync with the ctypes.Structure in deviceplugin/discovery.py
// (nvdisc_struct_size lets Python check the layout).
struct NvdiscCard {
  int32_t index;          // host index: the node's minor (nvidiaN -> N)
  int32_t pci_vendor;     // PCI vendor id (0x10de == NVIDIA) or 0
  int32_t pci_device;     // PCI device id or 0
  int32_t numa_node;      // NUMA node or -1
  char device_path[256];  // e.g. "/dev/nvidia3"
  char bus_id[32];        // e.g. "0000:18:00.0", or "" when unknown
  char model[64];         // the module's "Model:" line, or ""
};

const char* nvdisc_version(void) { return "nvdisc/1.0"; }

int nvdisc_struct_size(void) { return static_cast<int>(sizeof(NvdiscCard)); }

}  // extern "C"

namespace {

// Read a small file into `out`, trailing whitespace trimmed; false when
// unreadable.
bool ReadFileString(const std::string& path, std::string* out) {
  FILE* f = std::fopen(path.c_str(), "r");
  if (f == nullptr) return false;
  char buf[4096];
  size_t n = std::fread(buf, 1, sizeof(buf) - 1, f);
  std::fclose(f);
  buf[n] = '\0';
  while (n > 0 && std::isspace(static_cast<unsigned char>(buf[n - 1])))
    buf[--n] = '\0';
  *out = buf;
  return true;
}

bool ReadFileHex(const std::string& path, int32_t* out) {
  std::string s;
  unsigned v = 0;
  if (!ReadFileString(path, &s) || std::sscanf(s.c_str(), "%x", &v) != 1)
    return false;
  *out = static_cast<int32_t>(v);
  return true;
}

bool ReadFileInt(const std::string& path, int32_t* out) {
  std::string s;
  int v = 0;
  if (!ReadFileString(path, &s) || std::sscanf(s.c_str(), "%d", &v) != 1)
    return false;
  *out = v;
  return true;
}

std::string Trim(const std::string& s) {
  size_t b = 0, e = s.size();
  while (b < e && std::isspace(static_cast<unsigned char>(s[b]))) b++;
  while (e > b && std::isspace(static_cast<unsigned char>(s[e - 1]))) e--;
  return s.substr(b, e - b);
}

// "nvidia<digits>" -> the digits' value; -1 for any other name.
int CardIndex(const char* name) {
  if (std::strncmp(name, "nvidia", 6) != 0) return -1;
  const char* digits = name + 6;
  if (*digits == '\0') return -1;
  for (const char* p = digits; *p; p++)
    if (!std::isdigit(static_cast<unsigned char>(*p))) return -1;
  errno = 0;
  long v = std::strtol(digits, nullptr, 10);
  if (errno != 0 || v > (1L << 20)) return -1;
  return static_cast<int>(v);
}

// The module's per-card file: its minor and model line. False
// when it has no "Device Minor" line.
bool ParseInformation(const std::string& path, int* minor,
                      std::string* model) {
  std::string text;
  if (!ReadFileString(path, &text)) return false;
  bool found = false;
  size_t start = 0;
  while (start <= text.size()) {
    size_t end = text.find('\n', start);
    if (end == std::string::npos) end = text.size();
    std::string line = text.substr(start, end - start);
    size_t colon = line.find(':');
    if (colon != std::string::npos) {
      std::string key = Trim(line.substr(0, colon));
      std::string val = Trim(line.substr(colon + 1));
      for (char& c : key) c = static_cast<char>(std::tolower(c));
      if (key == "device minor") {
        char* rest = nullptr;
        long v = std::strtol(val.c_str(), &rest, 10);
        if (rest != val.c_str() && *rest == '\0' && v >= 0) {
          *minor = static_cast<int>(v);
          found = true;
        }
      } else if (key == "model") {
        *model = val;
      }
    }
    start = end + 1;
  }
  return found;
}

// Name `card` from procfs and sysfs where they show it.
void FillFromProcfs(const std::string& procfs_root,
                    const std::string& sysfs_root, NvdiscCard* card) {
  std::string gpus = procfs_root + "/driver/nvidia/gpus";
  DIR* d = opendir(gpus.c_str());
  if (d == nullptr) return;
  struct dirent* ent;
  while ((ent = readdir(d)) != nullptr) {
    if (ent->d_name[0] == '.') continue;
    int minor = -1;
    std::string model;
    if (!ParseInformation(gpus + "/" + ent->d_name + "/information", &minor,
                          &model) ||
        minor != card->index)
      continue;
    std::snprintf(card->bus_id, sizeof(card->bus_id), "%s", ent->d_name);
    std::snprintf(card->model, sizeof(card->model), "%s", model.c_str());
    std::string base = sysfs_root + "/bus/pci/devices/" + ent->d_name;
    ReadFileHex(base + "/vendor", &card->pci_vendor);
    ReadFileHex(base + "/device", &card->pci_device);
    ReadFileInt(base + "/numa_node", &card->numa_node);
    break;
  }
  closedir(d);
}

// Append the cards of one directory; returns the new count.
int ScanDir(const std::string& dir, NvdiscCard* out, int max_cards,
            int found) {
  DIR* d = opendir(dir.c_str());
  if (d == nullptr) return found;
  struct dirent* ent;
  while ((ent = readdir(d)) != nullptr && found < max_cards) {
    int index = CardIndex(ent->d_name);
    if (index < 0) continue;
    bool dup = false;
    for (int i = 0; i < found; i++)
      if (out[i].index == index) dup = true;
    if (dup) continue;
    NvdiscCard* card = &out[found];
    std::memset(card, 0, sizeof(*card));
    card->index = index;
    card->numa_node = -1;
    int len = std::snprintf(card->device_path, sizeof(card->device_path),
                            "%s/%s", dir.c_str(), ent->d_name);
    if (len < 0 || len >= static_cast<int>(sizeof(card->device_path)))
      continue;  // unreachable: nvdisc_enumerate bounds the root's length
    found++;
  }
  closedir(d);
  return found;
}

}  // namespace

extern "C" {

// Enumerate the NVIDIA cards under devfs_root, named from procfs_root and
// sysfs_root where they show them. Returns the number of cards written to
// `out` (sorted by index), 0 when none is found, -1 on bad arguments (no
// buffer, max_cards <= 0, an empty root, or a devfs root too long for a
// card's device_path). NULL roots default to "/dev", "/sys" and "/proc".
// An empty root is refused rather than read: joined to a node's name it
// would name a path under "/".
int nvdisc_enumerate(NvdiscCard* out, int max_cards, const char* devfs_root,
                     const char* sysfs_root, const char* procfs_root) {
  if (out == nullptr || max_cards <= 0) return -1;
  for (const char* root : {devfs_root, sysfs_root, procfs_root})
    if (root != nullptr && root[0] == '\0') return -1;
  std::string dev = devfs_root ? devfs_root : "/dev";
  if (dev.size() + sizeof("/nvidia/nvidia1048576") > sizeof(out->device_path))
    return -1;
  std::string sys = sysfs_root ? sysfs_root : "/sys";
  std::string proc = procfs_root ? procfs_root : "/proc";
  int found = ScanDir(dev, out, max_cards, 0);
  found = ScanDir(dev + "/nvidia", out, max_cards, found);
  for (int i = 0; i < found; i++) FillFromProcfs(proc, sys, &out[i]);
  // Insertion sort by index (a handful of cards).
  for (int i = 1; i < found; i++) {
    NvdiscCard key = out[i];
    int j = i - 1;
    while (j >= 0 && out[j].index > key.index) {
      out[j + 1] = out[j];
      j--;
    }
    out[j + 1] = key;
  }
  return found;
}

}  // extern "C"
